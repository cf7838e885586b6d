"""The benchmark's own tests: ``python -m pytest benchmark/tests``.  The
harness and the port are imported from the checkout."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small_cell(monkeypatch):
    """``small_cell(workload, **mix)``: the cell found by its name as
    ever, its traffic's parameters overridden by ``mix``, so that a test
    drives it at a size that a test run holds."""
    from harness import cells
    found = cells.cell

    def shrink(workload, **overrides):
        def cell(name, spec=None):
            c = found(name, spec)
            if name == workload:
                c["mix"] = {**c["mix"], **overrides}
            return c
        monkeypatch.setattr(cells, "cell", cell)
    return shrink


@pytest.fixture
def on_the_cpu(monkeypatch):
    """A run without a card: ``run.DEVICE`` the CPU, the library's load
    and the card's calls stubbed, the port's plain kernels in their
    place."""
    import torch

    import run
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run, "_load_library",
                        lambda: {"compiled": False, "seconds": 0.0})
    monkeypatch.setattr(run, "_card", lambda: {})
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    return run
