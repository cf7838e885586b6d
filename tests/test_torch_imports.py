"""Guards of the PyTorch port's boundaries.

* Importing ``sdr_tpu_torch`` and every submodule loads no ``jax`` and
  nothing of the JAX package ``sdr_tpu``, not even its numpy modules: the
  machine with the GPU has no JAX, and the port keeps its own copies (its
  golden receiver and utilities among them).  Checked in a fresh
  interpreter whose import system refuses both (for the port, the profile
  script, ``chip_smoke.py`` and ``bench_torch.py``), and by
  scanning the imports of the port, ``chip_smoke.py``, ``bench_torch.py``,
  the card-only tests and the port's scripts (``scripts/torch_*.py``).
* A kernel wrapper handed a CUDA tensor launches its kernel or raises: no
  kernel module catches an exception and falls back to the plain version,
  and a block program whose capture fails re-raises instead of running the
  eager block.
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


#: the modules and scripts the port added last, each its JAX counterpart's
#: copy or counterpart: the float64 golden receiver, the utilities and the
#: per-stage profile
NEWEST = ("sdr_tpu_torch.golden.demod", "sdr_tpu_torch.golden.pll",
          "sdr_tpu_torch.golden.spectrum", "sdr_tpu_torch.golden.receiver",
          "sdr_tpu_torch.utils.gen", "sdr_tpu_torch.utils.logfiles",
          "sdr_tpu_torch.utils.profiling", "sdr_tpu_torch.utils.plotting",
          "sdr_tpu_torch.utils.anim")
SCRIPTS = ("torch_profile_stages", "torch_studies")


def test_guards_cover_the_newest_modules():
    assert set(NEWEST) <= set(_port_modules())


def test_scripts_and_smoke_load_no_jax():
    """The profile script, ``chip_smoke.py`` and ``bench_torch.py`` import
    (their bodies run only as ``__main__``) in an interpreter that refuses
    jax and ``sdr_tpu``."""
    code = f"""
import importlib, sys
sys.path.insert(0, {str(ROOT / "scripts")!r})

def refused(name):
    return (name in ("jax", "sdr_tpu")
            or name.startswith(("jax.", "jaxlib", "sdr_tpu.")))

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError("the PyTorch port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
for mod in {SCRIPTS!r} + ("chip_smoke", "bench_torch"):
    importlib.import_module(mod)
assert not [m for m in sys.modules if refused(m)]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "bench_torch.py", "tests/test_torch_cuda.py",
       "tests/torch_multiprocess.py"]
    + sorted(str(p.relative_to(ROOT))
             for p in (ROOT / "scripts").glob("torch_*.py")))
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


def test_block_program_does_not_fall_back():
    """Every exception handler of the block programs re-raises: a capture
    or replay that fails propagates instead of running the eager block."""
    tree = ast.parse((PORT / "models/program.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers and all(isinstance(h.body[-1], ast.Raise)
                            and h.body[-1].exc is None for h in handlers)


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
