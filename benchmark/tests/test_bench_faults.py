"""A run with the timed path broken underneath has to come out not
correct.  Each test skips the harness's look for a card and drives the
rest of a run on the CPU at a small size (the port's plain versions of
its kernels), with one fault of ``harness/faults.py`` planted: a step
that returns its state unchanged, half of the batch left out, one sample
of an arm that no PLL feeds altered, one channel's answer on an arm
downstream of a PLL altered, one PLL's state dropped where the stream
crosses the ring's wrap (in a monitor also a chunk boundary), and the
pilot PLL's input negated once a block where it is largest, a decision
that no rounding can flip and so no branch of the reference covers.
Every fault in every cell, but half of the batch in a listener, whose
batch is one channel.  (One card holds the whole cell, so there is no
exchange between chips to leave out.)  The sound run beside them comes
out correct."""

import pytest

from harness import faults

SEED = 2 ** 33 + 101
TINY = dict(stations=2, ring_blocks=2, chunk_blocks=2, warm_blocks=1,
            check_blocks_after_wrap=1)
MONITOR = dict(TINY, channels=4, check_rows=4, reference_workers=2)
LISTENER = dict(TINY, channels=1, stations=1, check_rows=1,
                reference_workers=1)
CELLS = {"m0_monitor_c512": MONITOR, "m0_listener_c1": LISTENER,
         "m2_monitor_c512": MONITOR, "m2_listener_c1": LISTENER}


def _run(run, small_cell, workload):
    small_cell(workload, **CELLS[workload])
    return run.run(workload, SEED, 0.0, False)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload, on_the_cpu, small_cell):
    out = _run(on_the_cpu, small_cell, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(CELLS) for f in sorted(faults.FAULTS)
    if not (f == "half_batch" and CELLS[w] is LISTENER)])
def test_broken_step_is_not_correct(workload, fault, on_the_cpu, small_cell,
                                    monkeypatch):
    from harness import cells
    faults.FAULTS[fault](monkeypatch, {**cells.cell(workload)["mix"],
                                       **CELLS[workload]})
    out = _run(on_the_cpu, small_cell, workload)
    assert not out["correct"], out["checks"]
