"""The port stands alone: importing every acestep_torch module, and the
chip smoke script, pulls in neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

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
    assert "acestep_torch.ops.flash_attention" in mods
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


def test_chip_smoke_imports_without_jax():
    res = _run("import sys, chip_smoke\n"
               "assert not any(m == 'jax' or m.startswith(('jax.', "
               "'acestep_tpu')) for m in sys.modules)\n")
    assert res.returncode == 0, res.stderr
