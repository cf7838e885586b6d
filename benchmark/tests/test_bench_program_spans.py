"""The readers of the port's own spans (``sdr.*``, recorded by
``sdr_tpu_torch.utils.profiling.span``), on synthetic events."""

from types import SimpleNamespace

import pytest

from harness import trace

CFG = {"block_bytes": 115_200, "rf_decim": 10, "rf_taps": 151}
K2 = "void (anonymous namespace)::pll_kernel<false>(float const*, float*)"

#: reader -> (span it reads, totalled per block step or the median)
PER_BLOCK = {"stage_ms_per_block": "sdr.program.stage",
             "staging_wait_ms_per_block": "sdr.program.staging_wait",
             "device_wait_ms_per_block": "sdr.receiver.wait",
             "fetch_ms_per_block": "sdr.receiver.fetch"}
MEDIAN = {"inputs_ms.latency": "sdr.program.inputs",
          "load_ms.latency": "sdr.program.load",
          "launch_ms.latency": "sdr.program.replay",
          "copy_out_ms.latency": "sdr.program.copy_out"}
READERS = [*PER_BLOCK, *MEDIAN, "idle_in_program_ms.latency"]


def _trace(device=(), host=(), blocks=4):
    return trace.Trace(list(device), list(host), (0.0, 1000.0), blocks, CFG,
                       {"channels": 1})


@pytest.mark.parametrize("metric", list(PER_BLOCK))
def test_per_block_readers_total_their_span_over_the_steps(metric):
    name = PER_BLOCK[metric]
    t = _trace(host=[(name, 10, 40), (name, 100, 150), ("sdr.other", 200, 900),
                     (name, 990, 1010)])      # the last one leaves the window
    assert trace.reader(metric)(t) == pytest.approx(0.080 / 4)


@pytest.mark.parametrize("metric", list(MEDIAN))
def test_median_readers_take_their_span_median(metric):
    name = MEDIAN[metric]
    t = _trace(host=[(name, 0, 30), (name, 100, 110), (name, 200, 250),
                     ("entry_call", 300, 800)])
    assert trace.reader(metric)(t) == pytest.approx(0.030)


@pytest.mark.parametrize("metric", READERS)
def test_readers_without_their_span_return_none(metric):
    t = _trace(device=[(K2, 0, 500)],
               host=[("entry_call", 0, 400), ("aten::copy_", 10, 20),
                     ("schedule_wait", 400, 1000), ("fetch", 500, 600)])
    assert trace.reader(metric)(t) is None


def test_idle_in_program_counts_idle_inside_port_spans_only():
    """Idle under ``schedule_wait`` or the harness's ``fetch`` is not the
    port's; busy time inside a port span is not idle; nested port spans
    count once."""
    t = _trace(
        device=[(K2, 150, 300), ("Memcpy DtoH (Device -> Pageable)", 310, 320),
                (K2, 650, 700)],
        host=[("traced_window", 0, 1000), ("schedule_wait", 0, 100),
              ("entry_call", 100, 400),
              ("sdr.program.inputs", 100, 140),         # idle 40
              ("sdr.program.capture", 140, 200),        # idle 140-150: 10
              ("sdr.program.load", 145, 190),           # inside capture
              ("sdr.program.replay", 200, 260),         # busy
              ("sdr.program.copy_out", 300, 330),       # idle 300-310, 320-330
              ("fetch", 400, 500),
              ("schedule_wait", 500, 600),
              ("sdr.program.inputs", 600, 660),         # idle 600-650
              ("sdr.program.replay", 990, 1100)])       # clipped: idle 10
    assert trace.reader("idle_in_program_ms.latency")(t) == pytest.approx(
        1e-3 * (40 + 10 + 20 + 50 + 10) / 4)


def test_idle_in_program_is_zero_when_the_device_covers_the_spans():
    t = _trace(device=[(K2, 0, 1000)],
               host=[("sdr.program.replay", 10, 20),
                     ("sdr.program.copy_out", 30, 40)])
    assert trace.reader("idle_in_program_ms.latency")(t) == 0.0


def test_device_annotations_of_port_spans_are_not_device_work():
    """A profile's device side of a ``record_function`` span is a user
    annotation: ``Trace.from_profiler`` keeps the kernel and drops it, so
    the busy and idle readers never count a span as work."""
    from torch.autograd import DeviceType

    def ev(name, a, b, dev, annotation=False):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a, end=b),
                               is_user_annotation=annotation)
    events = [ev("traced_window", 0, 1000, DeviceType.CPU),
              ev("sdr.program.replay", 100, 120, DeviceType.CPU),
              ev("sdr.program.replay", 110, 900, DeviceType.CUDA, True),
              ev("sdr.receiver.fetch", 500, 700, DeviceType.CUDA, True),
              ev(K2, 200, 300, DeviceType.CUDA)]
    prof = SimpleNamespace(events=lambda: events)
    t = trace.Trace.from_profiler(prof, 4, CFG, {"channels": 1})
    assert t.device == [(K2, 200.0, 300.0)]
    assert t.busy_s == pytest.approx(100e-6)
    assert trace.reader("launch_ms.latency")(t) == pytest.approx(0.020)
    assert trace.reader("idle_in_program_ms.latency")(t) == pytest.approx(
        1e-3 * 20 / 4)
