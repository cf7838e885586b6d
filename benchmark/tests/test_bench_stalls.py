"""The record of what made a listener block late (``harness/stalls.py``
and what ``drivers.listener`` records for it): the attribution on
synthetic records, and runs of the listener cell on the CPU at a small
size with a stall planted in ``Receiver.process``."""

import gc
import time

import pytest

from harness import drivers, stalls, window

SEED = 2 ** 33 + 211
WORKLOAD = "m0_listener_c1"
SMALL = dict(stations=1, ring_blocks=2, warm_blocks=1,
             check_blocks_after_wrap=1, channels=1, check_rows=1,
             reference_workers=1)
#: the window's block that meets the planted stall
PLANTED = 5


def _late(**kw):
    """A late block as ``drivers.listener`` records it: due at 1.0 s,
    done 30 ms later, on its CPU in user mode all along, unless ``kw``
    says else."""
    b = {"index": 7, "due": 1.0, "done": 1.030, "wall_s": 0.024,
         "cpu_s": 0.024, "sys_s": 0.0, "nivcsw": 0, "nvcsw": 0,
         "minflt": 0, "majflt": 0, "throttle": (0, 0)}
    return {**b, **kw}


def test_collector_ms_counts_only_the_overlap():
    passes = [(0, 0.990, 20.0, 5),      # 0.990-1.010: 10 ms inside
              (2, 1.020, 5.0, 0),       # inside: 5
              (1, 1.028, 10.0, 0),      # 1.028-1.038: 2 inside
              (2, 1.100, 50.0, 0)]      # after
    assert stalls.collector_ms(passes, 1.0, 1.030) == pytest.approx(17.0)


@pytest.mark.parametrize("kw,passes,want", [
    ({}, [(2, 1.002, 20.0, 0)], "collector"),
    ({"cpu_s": 0.005, "throttle": (3, 25_000)}, [], "throttled"),
    ({"majflt": 1}, [], "faults"),
    ({"minflt": 9000, "sys_s": 0.02}, [], "faults"),
    ({"cpu_s": 0.02, "sys_s": 0.02}, [], "system"),
    ({"cpu_s": 0.006, "nivcsw": 2}, [], "descheduled"),
    ({"cpu_s": 0.006, "nvcsw": 1, "throttle": None}, [], "descheduled"),
    ({"minflt": 20}, [(0, 1.002, 0.5, 0)], "unnamed")])
def test_cause_is_the_first_that_accounts_for_half_the_stall(kw, passes,
                                                             want):
    # a 30 ms latency against a 1 ms median: a 29 ms stall
    (rec,) = stalls.attribute([_late(**kw)], passes, 0.001)
    assert rec["cause"] == want
    assert rec["latency_ms"] == pytest.approx(30.0)


def test_a_block_no_slower_than_the_median_is_unnamed():
    # every block past its period (the port slower than the signal): the
    # collector and the fault meet no stall to account for
    (rec,) = stalls.attribute([_late(majflt=1)], [(2, 1.002, 20.0, 0)],
                              0.035)
    assert rec["cause"] == "unnamed"


def test_a_block_queued_behind_a_late_one_takes_its_cause():
    # block 7 slept 40 ms; 8, due 24 ms after 7, was submitted when 7 was
    # done and met nothing of its own
    first = _late(index=7, due=1.0, done=1.041, wall_s=0.060, cpu_s=0.018,
                  nvcsw=1)
    queued = _late(index=8, due=1.024, done=1.050, wall_s=0.009,
                   cpu_s=0.009)
    alone = _late(index=10, due=1.072, done=1.100, wall_s=0.030,
                  cpu_s=0.030)
    recs = stalls.attribute([first, queued, alone], [], 0.001)
    assert [r["cause"] for r in recs] == ["descheduled", "descheduled",
                                          "unnamed"]
    assert recs[1]["queued_ms"] == pytest.approx(17.0)
    assert recs[2]["queued_ms"] == 0.0


def test_summary_counts_causes_and_full_passes_and_keeps_twenty():
    late = [_late(index=2 * i, due=1.0 + i, done=1.03 + i)
            for i in range(25)]
    passes = [(2, 1.001, 25.0, 0), (0, 2.0, 0.1, 0), (2, 3.002, 28.0, 0),
              (1, 9.0, 0.3, 0)]
    s = stalls.summary([0.001] * 100 + [0.030] * 25, late, passes, {}, {})
    assert s["late"] == 25 and len(s["blocks"]) == stalls.KEEP
    assert s["by_cause"] == {"collector": 2, "throttled": 0, "faults": 0,
                             "system": 0, "descheduled": 0, "unnamed": 23}
    assert s["full_passes"] == 2 and s["passes"] == [1, 1, 2]
    assert s["pass_ms_max"] == [0.1, 0.3, 28.0]
    assert s["full_pass_ms_max"] == 28.0
    assert s["full_pass_ms_sum"] == pytest.approx(53.0)


def test_no_full_pass_reads_none_and_zero():
    s = stalls.summary([0.001] * 3, [], [(0, 1.0, 0.1, 0)], {}, {})
    assert s["late"] == 0 and s["full_passes"] == 0
    assert s["full_pass_ms_max"] is None and s["full_pass_ms_sum"] == 0.0
    assert s["pass_ms_max"] == [0.1, None, None]


@pytest.mark.parametrize("text,want", [
    ("usage_usec 10\nnr_periods 40\nnr_throttled 3\nthrottled_usec 2500\n",
     (3, 2500)),
    ("usage_usec 10\n", None)])
def test_throttling_reads_the_cgroups_cpu_stat(tmp_path, text, want):
    f = tmp_path / "cpu.stat"
    f.write_text(text)
    assert drivers.throttling(f) == want
    assert drivers.throttling(None) is None
    assert drivers.throttling(tmp_path / "absent") is None


@pytest.fixture
def listener_run(on_the_cpu, small_cell, monkeypatch):
    """``listener_run(plant)``: a run of the listener cell on the CPU
    over 10 blocks, ``Receiver.process`` returning its first call's
    outputs (so a block takes well under its period) and calling
    ``plant()`` on the window's block :data:`PLANTED`."""
    from sdr_tpu_torch.models.receiver import Receiver
    real = Receiver.process

    def run(plant):
        calls, first = [], []

        def process(self, x):
            if not first:
                first.append(real(self, x))
            if len(calls) == SMALL["warm_blocks"] + PLANTED:
                plant()
            calls.append(1)
            return first[0]

        monkeypatch.setattr(Receiver, "process", process)
        small_cell(WORKLOAD, **SMALL)
        return on_the_cpu.run(WORKLOAD, SEED, 10 * 0.024, False)
    return run


def _planted(out):
    s = out["stalls"]
    assert s["late"] == out["failed"] == sum(s["by_cause"].values())
    return next(b for b in s["blocks"] if b["index"] == PLANTED)


def test_a_full_pass_over_planted_garbage_is_named_collector(listener_run):
    def plant():
        for _ in range(100_000):
            cycle = []
            cycle.append(cycle)
        gc.collect()

    out = listener_run(plant)
    b = _planted(out)
    assert b["latency_ms"] > 24.0 and b["cause"] == "collector"
    s = out["stalls"]
    assert s["full_passes"] >= 1 and s["full_pass_ms_max"] > 12.0
    assert b["collector_ms"] >= s["full_pass_ms_max"] > 0


def test_a_planted_sleep_is_not_named_collector(listener_run):
    out = listener_run(lambda: time.sleep(0.08))
    b = _planted(out)
    assert b["latency_ms"] > 24.0 and b["cause"] == "descheduled"
    assert b["off_cpu_ms"] > 40.0
    assert b["collector_ms"] < 10.0


def test_listener_line_keeps_its_keys_and_values(on_the_cpu, small_cell,
                                                 monkeypatch):
    """The keys of the line are the ones it had, in their order, with
    ``stalls`` and ``pilot_branches`` before ``checks``; ``correct``,
    ``attempted``, ``failed`` and the metrics are what the window
    arithmetic gives on the listener's own latencies, as before the
    record."""
    seen = {}
    real = drivers.DRIVERS["listener"]

    def listener(*a):
        seen.update(real(*a))
        return seen

    monkeypatch.setitem(drivers.DRIVERS, "listener", listener)
    small_cell(WORKLOAD, **SMALL)
    out = on_the_cpu.run(WORKLOAD, SEED, 0.0, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "card", "seed", "build", "stalls",
                         "pilot_branches", "checks"]
    lat = seen["latencies"]
    assert out["correct"] is True
    assert out["attempted"] == len(lat) == seen["blocks"]
    assert out["failed"] == window.late(lat, seen["period"])
    assert out["stalls"]["late"] == out["failed"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m == {"block_latency_p50_ms": window.percentile_ms(lat, 50),
                 "block_latency_p95_ms": window.percentile_ms(lat, 95),
                 "setup_s": seen["t_first"] - on_the_cpu.T_START}
    assert out["stalls"]["probe"]["full_pass_ms"] > 0
