"""The port stands alone: importing every acestep_torch module, the chip
smoke script and the port's tools (the environment doctor, the profiler
harness, the memory profiler, the benchmark and the DiT A/B) pulls in
neither JAX nor the JAX package;
the real-checkpoint parity harness is the one tool that imports both, as
it compares them."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    pkg = ROOT / "acestep_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"acestep_torch.ops.flash_attention",
            "acestep_torch.parallel.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'acestep_tpu' or "
        "m.startswith('acestep_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_port_tools_import_without_jax():
    res = _run("import sys\n"
               "sys.path.insert(0, 'scripts')\n"
               "import check_gpu, profile_inference_torch, profile_vram\n"
               "import bench_torch, profile_dit_ab_torch\n"
               "assert not any(m == 'jax' or m.startswith(('jax.', "
               "'acestep_tpu')) for m in sys.modules)\n")
    assert res.returncode == 0, res.stderr


def test_only_the_parity_harness_imports_both_packages():
    """The scan's list of tools is every tool of the port: each
    `*_torch.py` tool and the new scripts are in one of the two lists, and
    the parity harness is the one that names the JAX package."""
    tools = {str(p.relative_to(ROOT)) for p in ROOT.glob("*_torch.py")} | {
        str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("*.py")
        if p.name in ("check_gpu.py", "profile_vram.py")
        or p.name.endswith("_torch.py") or p.name.startswith("torch_")}
    assert tools == set(PORT_TOOLS + COMPARES_BOTH)
    for rel in COMPARES_BOTH:
        src = (ROOT / rel).read_text()
        assert {m.split(".")[0] for _, m in _jax_imports(src, rel)} == {
            "jax", "acestep_tpu"}


def test_chip_smoke_imports_without_jax():
    res = _run("import sys, chip_smoke\n"
               "assert not any(m == 'jax' or m.startswith(('jax.', "
               "'acestep_tpu')) for m in sys.modules)\n")
    assert res.returncode == 0, res.stderr


# the port's tools beside the package: none imports JAX or the JAX package
PORT_TOOLS = ["scripts/check_gpu.py", "profile_inference_torch.py",
              "scripts/profile_vram.py", "scripts/torch_lm_profile.py",
              "scripts/torch_train_profile.py", "bench_torch.py",
              "scripts/profile_dit_ab_torch.py"]
# the one tool that compares the two packages, so imports both
COMPARES_BOTH = ["scripts/parity_real_torch.py"]


def _import_scan_files():
    return sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "acestep_torch").rglob("*.py")) + [
        "chip_smoke.py"] + PORT_TOOLS


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "acestep_tpu")


def _jax_imports(source: str, filename: str = "<src>"):
    """(line, module) of every import statement in `source` that names jax
    or the JAX package, at module level or inside a function, class or
    branch, and of `importlib.import_module` / `__import__` calls with a
    literal name."""
    import ast

    bad = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module and _forbidden(node.module):
            bad.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and \
                _forbidden(node.args[0].value):
            bad.append((node.lineno, node.args[0].value))
    return bad


@pytest.mark.parametrize("rel", _import_scan_files())
def test_no_jax_import_at_any_depth(rel):
    """Every import of the port and of chip_smoke.py, at any depth, names
    neither jax nor the JAX package: importing a module alone would miss
    one inside a function, which would fail only where it runs."""
    bad = _jax_imports((ROOT / rel).read_text(), rel)
    assert not bad, f"{rel} imports {bad}"


def test_import_scan_catches_imports_at_any_depth():
    """The scan's own control: imports it must catch and ones it must
    leave alone."""
    src = ("import os\n"
           "def f():\n"
           "    from acestep_tpu.utils import flac\n"
           "    class C:\n"
           "        import jax.numpy as jnp\n"
           "    if True:\n"
           "        importlib.import_module('jax')\n"
           "    from acestep_torch.utils import flac as g\n")
    assert _jax_imports(src) == [(3, "acestep_tpu.utils"), (5, "jax.numpy"),
                                 (7, "jax")]
