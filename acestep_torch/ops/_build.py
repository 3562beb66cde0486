"""Build and load the port's CUDA kernels (`acestep_torch/csrc/*.cu`).

Each source is compiled by its own `nvcc` process, all started together,
for `sm_90a`; the objects are linked into one shared library with a plain C
interface, loaded with `ctypes`. The library lives under `build/<hash>/` at
the repository root, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing is built at
import: the first kernel launch calls `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libacestep_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last build, if any
build_log: str = ""                     # nvcc's output (-Xptxas -v) of it

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # q, k, v, out, lse, B, Lq, Lk, Hq, Hkv, 9 strides, window, scale, stream
    "acestep_flash_fwd": [_VP] * 5 + [_I] * 5 + [_LL] * 9 + [_I, _F, _VP],
    # q, k, v, dout, lse, delta, dq, B, Lq, Lk, Hq, Hkv, window, scale, stream
    "acestep_flash_bwd_dq": [_VP] * 7 + [_I] * 6 + [_F, _VP],
    # q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, Hq, Hkv, window, scale,
    # stream
    "acestep_flash_bwd_dkv": [_VP] * 8 + [_I] * 6 + [_F, _VP],
    # x, out, scratch, w, b7, bp, ea, ieb, wmap, N, L, C, stream
    "acestep_snake_conv": [_VP] * 9 + [_I] * 3 + [_VP],
    # w, C, map_out
    "acestep_snake_conv_encode": [_VP, _I, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that runs them")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + NVCC_FLAGS:
        h.update(flag.encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path. Raises with nvcc's output when a step fails."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v",
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    build_seconds = time.time() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.acestep_error_string.argtypes = [ctypes.c_int]
            lib.acestep_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().acestep_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
