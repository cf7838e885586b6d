"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (``sdr_tpu_torch`` begins with ``sdr_tpu``); the
reference imports nothing of the port either."""

import ast
import sys
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sdr_tpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.partition(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for p in files:
        assert not _imports(p) & FORBIDDEN, p


def test_the_reference_imports_numpy_and_the_standard_library_alone():
    for name in ("reference.py", "stations.py", "roofline.py", "window.py"):
        tops = _imports(BENCH / "harness" / name)
        assert "sdr_tpu_torch" not in tops, name
    assert _imports(BENCH / "harness" / "reference.py") <= {
        "__future__", "concurrent", "math", "numpy", "pathlib", "pickle",
        "subprocess", "sys"}


def test_the_run_time_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdr_tpu_torch_fake", object())
    monkeypatch.delitem(sys.modules, "sdr_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    clean = run.forbidden_modules()
    assert "sdr_tpu" not in clean and "jax" not in clean
    monkeypatch.setitem(sys.modules, "sdr_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"sdr_tpu", "jax"} <= set(run.forbidden_modules())
