"""ctypes loader for the C FLAC bit-kernels (native/flacenc.c).

Compiles the shared object on demand with the system compiler (`cc`, or
`$CC`) into `build/flacenc-<source hash>/` at the repository root (beside
the CUDA kernels' library), so a changed source rebuilds. Every exported
symbol is None when no compiler is available — utils/flac.py then uses its
pure-Python paths, which produce byte-identical output (tested). This is
host code: the encoder runs on the CPU after the audio has left the card."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from acestep_torch.ops._build import BUILD_ROOT

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "flacenc.c")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ACESTEP_NO_NATIVE_FLAC") == "1":
        return None
    try:
        with open(_SRC, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()[:16]
        cache = BUILD_ROOT / f"flacenc-{key}"
        so_path = cache / "flacenc.so"
        if not so_path.exists():
            cache.mkdir(parents=True, exist_ok=True)
            cc = os.environ.get("CC", "cc")
            with tempfile.NamedTemporaryFile(
                    suffix=".so", dir=cache, delete=False) as tmp:
                subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp.name],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp.name, so_path)
        lib = ctypes.CDLL(str(so_path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.crc16.restype = ctypes.c_uint16
    lib.crc16.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.rice_encode.restype = ctypes.c_size_t
    lib.rice_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.rice_decode.restype = ctypes.c_size_t
    lib.rice_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t, ctypes.c_int]
    lib.lpc_reconstruct.restype = None
    lib.lpc_reconstruct.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
    _LIB = lib
    return _LIB


def _splice_bits(bw, packed: np.ndarray, nbits: int) -> None:
    """Append `nbits` bits from a byte-aligned uint8 buffer to a
    flac.BitWriter whose stream may be mid-byte — vectorized shift/merge
    instead of a per-byte Python loop."""
    k = bw.nbits
    nbytes = (nbits + 7) // 8
    data = packed[:nbytes]
    if k == 0:
        full, rem = divmod(nbits, 8)
        bw.buf += data[:full].tobytes()
        if rem:
            bw.write(int(data[full]) >> (8 - rem), rem)
        return
    # continuation byte i = low k bits of previous byte (or the writer's
    # pending accumulator) followed by the top 8-k bits of byte i
    a = np.concatenate([data, np.zeros(1, np.uint8)]).astype(np.uint16)
    lead = np.empty(len(a), np.uint16)
    lead[0] = (bw.acc << (8 - k)) & 0xFF
    lead[1:] = (a[:-1] << (8 - k)) & 0xFF
    merged = (lead | (a >> k)).astype(np.uint8)
    total = k + nbits
    full, rem = divmod(total, 8)
    bw.buf += merged[:full].tobytes()
    bw.acc = int(merged[full]) >> (8 - rem) if rem else 0
    bw.nbits = rem


def _native_rice_encode(bw, u: np.ndarray, param: int) -> None:
    """Append rice-coded values to a flac.BitWriter via the C kernel."""
    lib = _load()
    worst_bits = int((u >> np.uint64(param)).sum()) + len(u) * (1 + param)
    out = np.zeros((worst_bits + 7) // 8 + 16, np.uint8)
    uc = np.ascontiguousarray(u, np.uint64)
    nbits = lib.rice_encode(
        uc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(uc),
        param, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(out))
    if nbits == 0:
        raise RuntimeError("rice_encode buffer overflow")
    _splice_bits(bw, out, int(nbits))


def _native_rice_decode(data: bytes, bitpos: int, count: int, param: int):
    lib = _load()
    out = np.empty(count, np.uint64)
    newpos = lib.rice_decode(
        data, len(data), bitpos,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), count, param)
    if newpos == 0:
        raise ValueError("rice stream overran the buffer")
    return out, int(newpos)


def _native_crc16(data: bytes) -> int:
    return int(_LIB.crc16(data, len(data)))


def _native_lpc_reconstruct(samples: np.ndarray, coefs: np.ndarray,
                            order: int, shift: int) -> None:
    """In place: samples (int64, warmup then residuals) -> reconstructed."""
    lib = _load()
    s = samples          # caller guarantees contiguous int64
    c = np.ascontiguousarray(coefs, np.int64)
    lib.lpc_reconstruct(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(s),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), order, shift)


if _load() is not None:
    native_crc16 = _native_crc16
    native_rice_encode = _native_rice_encode
    native_rice_decode = _native_rice_decode
    native_lpc_reconstruct = _native_lpc_reconstruct
else:  # no compiler: flac.py falls back to pure Python
    native_crc16 = None
    native_rice_encode = None
    native_rice_decode = None
    native_lpc_reconstruct = None
