#!/usr/bin/env python3
"""A listener's stages on the host clock, untraced, against the same
stages under ``torch.profiler``, on one card.

One ``Receiver`` a mode (stereo, RDS, one channel) takes one host u8 block
at a time through ``Receiver.process`` on the signal's own schedule (a
block due every block's duration, spun for), and every arm it returns is
fetched to host numpy, as a listener does.  Three ways, in turns (off,
clock, traced, traced, clock, off):

* ``off``: no profiler, the spans the shared no-op; the host clock
  around ``process`` and around the fetch only;
* ``clock``: no profiler; ``profiling.span`` replaced in
  ``models.program`` and ``models.receiver`` by a host clock
  (``time.perf_counter_ns``) at each span's bounds, so each ``sdr.*``
  stage is timed as an untraced run executes it, at the cost of two
  clock reads a span;
* ``traced``: a CPU and CUDA ``torch.profiler`` profile over the blocks,
  as the benchmark's ``--trace 1`` window takes it: each stage from its
  span's ``record_function`` event, and the device busy time a block
  (the union of the device events that are not annotations).

``traced`` less ``clock``, stage by stage, is what the profiler adds to
the stages the benchmark's listener metrics read::

    python3 scripts/torch_span_clock.py [--modes 0 2] [--blocks 250]

Prints the card's name and power limit, one line a mode and way, and a
JSON line with every median (ms).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 20261018


class _Clock:
    """Stands in for ``profiling.span``: each span's host-clock time in
    ns, by name."""

    def __init__(self):
        self.ns: dict[str, list[int]] = defaultdict(list)

    def __call__(self, name: str) -> "_Mark":
        return _Mark(self.ns[name])


class _Mark:
    __slots__ = ("out", "t")

    def __init__(self, out: list[int]):
        self.out = out

    def __enter__(self):
        self.t = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.out.append(time.perf_counter_ns() - self.t)


def _busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Union length of (start, end) microsecond intervals, in ms."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _blocks(r, period: float, blocks: list[np.ndarray], n: int) -> dict:
    """``n`` blocks on the schedule: the host ms of each ``process`` call
    and each fetch."""
    call, fetch = [], []
    t0 = time.perf_counter() + period
    for k in range(n):
        due = t0 + k * period
        while time.perf_counter() < due:
            pass
        a = time.perf_counter()
        out = r.process(blocks[k % len(blocks)])
        b = time.perf_counter()
        [x.cpu().numpy() for x in out]
        fetch.append((time.perf_counter() - b) * 1e3)
        call.append((b - a) * 1e3)
    return {"process": call, "fetch": fetch}


def way(kind: str, r, period: float, blocks: list[np.ndarray], n: int
        ) -> dict:
    """The medians (ms) of one way over ``n`` blocks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdr_tpu_torch.models import program
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.utils import profiling

    stages: dict[str, list[float]] = {}
    busy = None
    if kind == "off":
        times = _blocks(r, period, blocks, n)
    elif kind == "clock":
        clock = _Clock()
        program.span = rx.span = clock
        try:
            times = _blocks(r, period, blocks, n)
        finally:
            program.span = rx.span = profiling.span
        stages = {k: [t / 1e6 for t in v] for k, v in clock.ns.items()}
    else:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            times = _blocks(r, period, blocks, n)
            torch.cuda.synchronize()
        dev = []
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not e.is_user_annotation:
                    dev.append((a, b))
            elif e.name.startswith("sdr."):
                stages.setdefault(e.name, []).append((b - a) / 1e3)
        busy = _busy_ms(dev) / n
    res = {k: statistics.median(v) for k, v in {**times, **stages}.items()}
    res["spans_per_block"] = sum(map(len, stages.values())) / n
    if busy is not None:
        res["device_busy"] = busy
    return res


def mode_cell(mode: int, n: int, rng) -> dict:
    from sdr_tpu_torch.models.receiver import Receiver

    r = Receiver(mode, stereo=True, with_rds=True, device="cuda")
    bs = r.mc.default_block_size(True)
    period = bs / 2 / r.mc.rf_fs
    blocks = list(rng.integers(0, 256, (16, bs), dtype=np.uint8))
    for b in blocks[:3]:
        [x.cpu().numpy() for x in r.process(b)]
    torch.cuda.synchronize()
    turns = []
    for kind in ("off", "clock", "traced", "traced", "clock", "off"):
        res = way(kind, r, period, blocks, n)
        turns.append({"way": kind, **res})
        print(f"mode {mode} {kind}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()), flush=True)
    return {"block_ms": period * 1e3, "turns": turns}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--blocks", type=int, default=250,
                    help="blocks a way (each on the block's own schedule)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(SEED)
    res = {"card": smi, "torch": torch.__version__,
           "modes": {m: mode_cell(m, args.blocks, rng) for m in args.modes}}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
