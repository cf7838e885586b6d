"""The reduction of a trace to the per-layer metrics, on synthetic
events."""

import pytest

from harness import trace

CFG = {"block_bytes": 115_200, "rf_decim": 10, "rf_taps": 151}
K1 = "void (anonymous namespace)::fir_kernel<8, (anonymous namespace)::U8In>"


def _trace(device, host=(), blocks=4):
    return trace.Trace(list(device), list(host), (0.0, 1000.0), blocks, CFG,
                       {"channels": 512})


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_busy_idle_and_per_block_readers():
    t = _trace([("Memcpy HtoD (Pinned -> Device)", 0, 100),
                ("sm80_xmma_gemm_f32f32", 50, 150),
                (K1, 200, 260), ("Memset (Device)", 300, 310),
                ("Memcpy DtoH (Device -> Pageable)", 900, 1100)])
    assert t.busy_s == pytest.approx(320e-6)      # clipped at the window
    assert trace.reader("device_idle.iq")(t) == pytest.approx(68.0)
    assert trace.reader("copy_ms_per_block")(t) == pytest.approx(0.2 / 4)
    assert trace.reader("compute_ms_per_block")(t) == pytest.approx(
        0.16 / 4)
    assert trace.reader("fir_gemm_ms_per_block")(t) == pytest.approx(0.025)
    assert trace.reader("device_ms_per_block.latency")(t) == pytest.approx(
        0.32 / 4)
    # K1 at C=512: 0.0266 ms bound over 0.130 ms of kernel (PERF.md's
    # kernel table: 20.4%)
    roof = trace.reader("frontend_roofline")(_trace([(K1, 0, 130)], blocks=1))
    assert roof == pytest.approx(100 * 0.02658 / 0.130, rel=2e-3)


def test_readers_with_nothing_to_read_return_none():
    t = _trace([("Memcpy HtoD (Pinned -> Device)", 0, 10)])
    for name in ("fir_gemm_ms_per_block", "frontend_roofline",
                 "pll_ms_per_block.latency", "entry_call_ms.latency",
                 "compute_ms_per_block"):
        assert trace.reader(name)(t) is None, name
    assert trace.reader("device_idle.iq")(_trace([])) is None


def test_idle_gaps_are_labelled_by_what_the_host_did():
    t = _trace([(K1, 0, 100), (K1, 600, 1000)],
               host=[("traced_window", 0, 1000), ("fetch", 90, 400),
                     ("aten::to", 95, 390), ("aten::copy_", 100, 380),
                     ("schedule_wait", 400, 600)])
    assert t.gaps() == [(100, 600)]
    assert t.label(250) == "fetch/aten::to"
    assert t.label(500) == "schedule_wait"
    bd = t.breakdown()
    assert bd["device_ops"] == [[K1, pytest.approx(5e-4)]]
    assert bd["idle_gaps"] == [["fetch/aten::to", pytest.approx(5e-4)]]


def test_spans_inside_the_window():
    t = _trace([], host=[("entry_call", 10, 30), ("entry_call", 990, 1010)])
    assert t.spans_s("entry_call") == [pytest.approx(2e-5)]
    assert trace.reader("entry_call_ms.latency")(t) == pytest.approx(0.02)
