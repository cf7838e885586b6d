"""Per-stage timing spans, the receiver's per-arm profile and the
analytical MAC accounting (SURVEY.md §5).

The port's counterpart of ``sdr_tpu/utils/profiling.py``, with its names
and contracts:

* ``StageTimer`` — context-manager spans with cumulative totals and a
  report() mirroring the reference's end-of-run printout (host clock; it
  times host-visible units: whole blocks, IO, host decode).
* ``trace_to(dir)`` — a ``torch.profiler`` trace of the CPU and, with a
  card, of the card, written under ``dir`` as a Chrome trace (the
  counterpart of ``jax.profiler.start_trace``).
* ``span(name)`` — the port's own spans (``sdr.*``: the block program's
  stages in ``models.program``, the streaming entry's in
  ``models.receiver``): a ``record_function`` range while a profile
  records, on the clock of the device activity it traces beside it; one
  shared no-op context otherwise.
* ``profile_stages`` — per-arm time by configuration deltas (front-end +
  mono, + stereo, + RDS): device time per block of the receiver's chunk
  program, replayed; per stage of the block,
  ``scripts/torch_profile_stages.py``.
* ``mac_per_audio_sample`` — the analytical MAC model reproducing report
  Table 1 exactly (1111/1313/~1200/~1567 mono, 2121/2525/~2300/~3033
  stereo for modes 0-3 at 101 taps) — the cost model's ground truth.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

from sdr_tpu_torch import config as cfg


class StageTimer:
    """Cumulative per-stage wall-clock spans
    (ref: src/project.cpp:72-91 pattern)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[stage] += dt
            self.counts[stage] += 1

    def report(self) -> str:
        lines = [f"{'stage':<24}{'total ms':>12}{'calls':>8}{'ms/call':>12}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[k] * 1e3
            n = self.counts[k]
            lines.append(f"{k:<24}{t:>12.2f}{n:>8}{t / n:>12.3f}")
        return "\n".join(lines)


#: what :func:`span` returns while no profile records: no allocation, no
#: clock read
_OFF = contextlib.nullcontext()
#: whether a ``torch.profiler`` profile records (the profiler's own flag)
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A span named ``name`` around the ``with`` block: while a
    ``torch.profiler`` profile records (``trace_to``, the benchmark's
    traced window), ``torch.profiler.record_function(name)``, a host event
    that the profile puts beside the kernels and copies the block caused,
    its parent the span that encloses it; while none records, one shared
    no-op context, so an untraced run pays a flag check a span.  Never
    inside a region under CUDA-graph capture: a replay runs no host code."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[str]:
    """Trace what runs inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity when there is a card) and write it as a
    Chrome trace (``chrome://tracing``, Perfetto) under ``log_dir``.
    Yields the trace's path, which exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


#: turns of :func:`profile_stages` on the card, taken round-robin over its
#: configurations; a configuration's time is the median of its turns
PROFILE_TURNS = 5


def profile_stages(mode: int = 0, n_blocks: int = 20, with_rds: bool = True,
                   device="cuda") -> dict[str, float]:
    """Per-arm time by configuration deltas.

    The receiver's block program (``receiver.make_block_fn``) runs in
    nested configurations — front-end + mono, + stereo, + RDS — over
    ``n_blocks`` consecutive raw u8 blocks of a synthesized station, and
    the deltas attribute time to each arm.  Returns per-block milliseconds
    per configuration plus the derived arm costs, with the keys of the JAX
    package's ``profile_stages``.

    Each configuration runs its blocks once as a chunk (``Program.scan``:
    on the card one CUDA graph of the ``n_blocks`` chained blocks, captured
    there), then replays that chunk (``Program.replay``: the state carries
    on in the program's buffers, nothing is copied in or out).  On the card
    a replay is timed by CUDA events, so the number is the device's time
    for a block, not the host's pace between calls; a configuration's time
    is the median of :data:`PROFILE_TURNS` replays, taken round-robin over
    the configurations, over ``n_blocks``.  On the CPU (only when
    ``device="cpu"`` is passed) one replay is timed by the host clock, which
    there times the work itself.  Raises without a card unless the CPU is
    asked for."""
    import statistics

    import numpy as np

    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.utils import synth

    dev = rx.resolve_device(device)
    rx.pin_fp32_matmul()
    mc = cfg.get_mode_config(mode)
    with_rds = with_rds and mc.rds is not None
    bs = mc.default_block_size(with_rds)
    res = synth.synthesize_fm(duration_s=(n_blocks + 1) * bs / 2 / mc.rf_fs,
                              mode=mode, with_rds=with_rds, seed=0)
    xs = torch.from_numpy(np.array(res.iq_u8[:n_blocks * bs])).reshape(
        n_blocks, bs).to(dev)
    coeffs = rx.design_coeffs(mc, device=dev)
    configs = {"mono_ms": (False, False), "stereo_ms": (True, False)}
    if with_rds:
        configs["stereo_rds_ms"] = (True, True)

    replays = {}
    for name, (stereo, rds) in configs.items():
        fn = rx.make_block_fn(mc, stereo=stereo, with_rds=rds)
        fn.scan(xs, coeffs, rx.init_state(mc, device=dev))
        key, = fn.keys()
        replays[name] = lambda fn=fn, key=key: fn.replay(key)

    def timed_ms(replay) -> float:
        if dev.type != "cuda":
            t0 = time.perf_counter()
            replay()
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        replay()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    turns: dict[str, list[float]] = {name: [] for name in configs}
    for _ in range(PROFILE_TURNS if dev.type == "cuda" else 1):
        for name, replay in replays.items():
            turns[name].append(timed_ms(replay) / n_blocks)
    ms = {name: statistics.median(t) for name, t in turns.items()}
    result = {"mono_ms": ms["mono_ms"], "stereo_ms": ms["stereo_ms"],
              "stereo_arm_ms": ms["stereo_ms"] - ms["mono_ms"],
              "realtime_budget_ms": bs / 2 / mc.rf_fs * 1e3}
    if with_rds:
        result["stereo_rds_ms"] = ms["stereo_rds_ms"]
        result["rds_arm_ms"] = ms["stereo_rds_ms"] - ms["stereo_ms"]
    return result


def mac_per_audio_sample(mc: cfg.ModeConfig, stereo: bool = False,
                         taps: int = 101) -> float:
    """MAC per output audio sample (report Table 1 model).

    Front-end: I+Q decimating FIRs produce one IF sample each per
    ``audio_decim/audio_upsamp`` audio samples at ``taps`` MACs apiece;
    mono resampler contributes ``taps`` MACs per audio sample (polyphase:
    ceil(taps*U / U) == taps); the stereo arm adds pilot+stereo band-pass
    at IF rate plus its own resampler.
    """
    if_per_audio = mc.audio_decim / mc.audio_upsamp
    front_end = 2 * taps * if_per_audio
    mono = front_end + taps
    if not stereo:
        return mono
    # Table 1's stereo increment is exactly the pilot+stereo band-pass pair
    # at IF rate (2121-1111 = 2*101*5 for mode 0); the reference does not
    # count the stereo arm's own audio FIR there — reproduced as-is so our
    # numbers are comparable to theirs.
    stereo_arm = 2 * taps * if_per_audio
    return mono + stereo_arm


def macs_per_second(mc: cfg.ModeConfig, stereo: bool = False,
                    taps: int = 101) -> float:
    """Aggregate MAC/s at the mode's audio rate — roofline numerator."""
    return mac_per_audio_sample(mc, stereo, taps) * mc.audio_fs
