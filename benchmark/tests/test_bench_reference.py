"""No run leaves a process behind.  The reference's worker processes: each
row spread over child processes gives the arms that the same row gives in
this process, and every child has ended when the call returns (a
``multiprocessing`` pool's resource tracker did not).  And a run ends any
child still alive before it prints its result."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import run
from harness import cells, reference


def _children() -> list[str]:
    me, out = str(os.getpid()), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me:
            out.append(stat.parent.name)
    return out


def test_workers_match_this_process_and_have_all_ended():
    cfg = cells.cell("m0_listener_c1")["config"]
    rng = np.random.default_rng(2 ** 33 + 7)
    rows = [rng.integers(0, 256, 2 * cfg["block_bytes"], dtype=np.uint8)
            for _ in range(3)]
    n_blocks = [3, 2, 1]
    before = set(_children())
    got = reference.run_rows(rows, cfg, n_blocks, workers=2)
    assert set(_children()) <= before
    want = reference.run_rows(rows, cfg, n_blocks, workers=1)
    assert len(got) == len(want) == 3
    for g, w, n in zip(got, want, n_blocks):
        assert sorted(g) == sorted(w)
        for arm in set(w) & set(reference.ARMS):
            assert g[arm].shape[0] == n
            np.testing.assert_array_equal(g[arm], w[arm])
        assert g["pilot"]["ambiguous"] == w["pilot"]["ambiguous"]
        assert len(g["pilot"]["branches"]) == len(w["pilot"]["branches"])
        for gb, wb in zip(g["pilot"]["branches"], w["pilot"]["branches"]):
            assert sorted(gb) == sorted(wb)
            for key in wb:
                np.testing.assert_array_equal(gb[key], wb[key])


def test_a_child_still_alive_is_ended_before_the_result():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        found = run.end_children(grace_s=5.0)
        assert child.pid in [pid for pid, _ in found]
        assert child.pid not in [pid for pid, _ in run.children()]
    finally:
        child.kill()
        child.wait()
    assert run.end_children() == []
