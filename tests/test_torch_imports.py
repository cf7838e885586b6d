"""Guards of the PyTorch port's boundaries.

* Importing ``sdr_tpu_torch`` and every submodule loads no ``jax`` and
  nothing of the JAX package ``sdr_tpu``, not even its numpy modules: the
  machine with the GPU has no JAX, and the port keeps its own copies.
  Checked in a fresh interpreter whose import system refuses both, and by
  scanning the imports of the port, ``chip_smoke.py`` and the card-only
  tests.
* A kernel wrapper handed a CUDA tensor launches its kernel or raises: no
  kernel module catches an exception and falls back to the plain version.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sdr_tpu_torch"
FORBIDDEN = ("jax", "sdr_tpu")
KERNEL_MODULES = ("ops/fir_frontend.py", "ops/fir_decim.py",
                  "ops/pll_cuda.py", "parallel/halo.py", "kernels/build.py")


def _port_modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax():
    code = f"""
import sys

def refused(name):
    return (name in ("jax", "sdr_tpu")
            or name.startswith(("jax.", "jaxlib", "sdr_tpu.")))

for name in [m for m in sys.modules if refused(m)]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError("the PyTorch port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
import importlib
for mod in {_port_modules()!r}:
    importlib.import_module(mod)
import sdr_tpu_torch
assert not [m for m in sys.modules if refused(m)]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "tests/test_torch_cuda.py"])
def test_no_forbidden_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
            if node.module == "sdr_tpu":
                names += [f"sdr_tpu.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert not any(name == f or name.startswith(f + ".")
                           for f in FORBIDDEN), f"{path}: imports {name}"


@pytest.mark.parametrize("path", KERNEL_MODULES)
def test_kernel_modules_do_not_fall_back(path):
    """No try/except in a kernel module: a failed build or launch
    propagates instead of silently running the plain version."""
    tree = ast.parse((PORT / path).read_text())
    handlers = [n.lineno for n in ast.walk(tree)
                if isinstance(n, (ast.Try, ast.ExceptHandler))]
    assert not handlers, f"{path}: exception handler at lines {handlers}"


def test_kernel_modules_import_no_triton_or_nvcc_at_import():
    """Importing a kernel module builds nothing: the build happens at the
    first launch on a CUDA tensor."""
    code = """
import sys
from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.parallel import halo
assert build.load.cache_info().currsize == 0
assert "triton" not in sys.modules
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]
