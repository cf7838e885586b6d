"""A run with the timed path broken underneath has to come out not
correct.  Each test skips the harness's look for a card and drives the
rest of a run on the CPU at a small size (the port's plain versions of
its kernels), with one fault of ``harness/faults.py`` planted: a step
that returns its state unchanged, half of the batch left out, one sample
of an arm that no PLL feeds altered, one channel's answer on an arm
downstream of a PLL altered, and one PLL's state dropped where the
stream crosses the ring's wrap (in a monitor also a chunk boundary).
(One card holds the whole cell, so there is no exchange between chips to
leave out.)  The sound run beside them comes out correct."""

import pytest

from harness import faults

SEED = 2 ** 33 + 101
TINY = dict(stations=2, ring_blocks=2, chunk_blocks=2, warm_blocks=1,
            check_blocks_after_wrap=1)
CELLS = {
    "m0_monitor_c512": dict(TINY, channels=4, check_rows=4,
                            reference_workers=2),
    "m0_listener_c1": dict(TINY, channels=1, stations=1, check_rows=1,
                           reference_workers=1),
}


def _run(run, small_cell, workload):
    small_cell(workload, **CELLS[workload])
    return run.run(workload, SEED, 0.0, False)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload, on_the_cpu, small_cell):
    out = _run(on_the_cpu, small_cell, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("m0_monitor_c512", "state_unchanged"),
    ("m0_monitor_c512", "half_batch"),
    ("m0_monitor_c512", "sample_altered"),
    ("m0_monitor_c512", "answer_altered"),
    ("m0_monitor_c512", "rds_pll_reset"),
    ("m0_monitor_c512", "pilot_pll_reset"),
    ("m0_listener_c1", "state_unchanged"),
    ("m0_listener_c1", "sample_altered"),
    ("m0_listener_c1", "answer_altered"),
    ("m0_listener_c1", "rds_pll_reset")])
def test_broken_step_is_not_correct(workload, fault, on_the_cpu, small_cell,
                                    monkeypatch):
    from harness import cells
    faults.FAULTS[fault](monkeypatch, {**cells.cell(workload)["mix"],
                                       **CELLS[workload]})
    out = _run(on_the_cpu, small_cell, workload)
    assert not out["correct"], out["checks"]
