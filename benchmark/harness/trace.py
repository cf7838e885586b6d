"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: device intervals (kernels, copies, sets) and the host's
operations and the harness's own spans, clipped to the traced window.

Times are the profiler's microseconds; host and device events share its
clock.  A device interval is a kernel, ``Memcpy ...`` or ``Memset ...``
activity; the device is busy where any runs (their union).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the harness's own spans (``record_function`` names); the outermost one
#: names what the host was doing in an idle gap
HARNESS_SPANS = ("traced_window", "schedule_wait", "entry_call", "fetch")
WINDOW = "traced_window"
METRICS_DIR = Path(__file__).resolve().parent.parent / "metrics"


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """One traced window of a cell: ``device`` is [(name, start_us,
    end_us)], ``host`` [(name, start_us, end_us)], ``window`` the traced
    span (start_us, end_us) and ``blocks`` the block steps it ran (a step
    is one block of every channel)."""

    def __init__(self, device, host, window, blocks: int, cfg: dict,
                 mix: dict):
        self.window = window
        lo, hi = window
        self.device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
                       if b > lo and a < hi]
        self.host = host
        self.blocks = blocks
        self.cfg, self.mix = cfg, mix

    @classmethod
    def from_profiler(cls, prof, blocks: int, cfg: dict, mix: dict
                      ) -> "Trace":
        from torch.autograd import DeviceType
        device, host, window = [], [], None
        for e in prof.events():
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                # the device side of a record_function span is an
                # annotation, not work
                if not (e.name in HARNESS_SPANS
                        or e.name.startswith("ProfilerStep")
                        or getattr(e, "is_user_annotation", False)):
                    device.append(span)
            elif e.device_type == DeviceType.CPU:
                host.append(span)
                if e.name == WINDOW:
                    window = span[1:]
        if window is None:
            raise RuntimeError("the trace holds no traced_window span")
        return cls(device, host, window, blocks, cfg, mix)

    # --- what the readers use ---------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in union(
            [(a, b) for _, a, b in self.device])) / 1e6

    @staticmethod
    def is_copy(name: str) -> bool:
        return name.startswith("Memcpy")

    @staticmethod
    def is_set(name: str) -> bool:
        return name.startswith("Memset")

    def device_s(self, keep) -> float:
        """Summed device seconds of the intervals whose name ``keep``
        accepts."""
        return sum(b - a for n, a, b in self.device if keep(n)) / 1e6

    def kernel_s(self, names: list[str]) -> float | None:
        """Device seconds of the kernels whose name holds one of
        ``names``; None where none ran."""
        hits = [(n, a, b) for n, a, b in self.device
                if not self.is_copy(n) and not self.is_set(n)
                and any(s in n for s in names)]
        return sum(b - a for _, a, b in hits) / 1e6 if hits else None

    def spans_s(self, name: str) -> list[float]:
        lo, hi = self.window
        return [(b - a) / 1e6 for n, a, b in self.host
                if n == name and a >= lo and b <= hi]

    @staticmethod
    def data(metric: str) -> list:
        """The data file beside a metric's reader
        (``metrics/<metric>.json``)."""
        return json.loads((METRICS_DIR / f"{metric}.json").read_text())

    # --- breakdown ----------------------------------------------------------

    def gaps(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        busy = union([(a, b) for _, a, b in self.device])
        out, t = [], lo
        for a, b in busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def label(self, t: float) -> str:
        """What the host was doing at ``t``: the outermost harness span
        (but the window's own) and the outermost operation inside it."""
        cover = sorted((a, -(b - a), n) for n, a, b in self.host
                       if a <= t <= b and n != WINDOW
                       and not n.startswith("ProfilerStep"))
        spans = [n for _, _, n in cover if n in HARNESS_SPANS]
        ops = [n for _, _, n in cover if n not in HARNESS_SPANS]
        parts = spans[:1] + ops[:1]
        return "/".join(parts) if parts else "host"

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for n, a, b in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        idle: dict[str, float] = {}
        for a, b in self.gaps():
            k = self.label((a + b) / 2)
            idle[k] = idle.get(k, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def reader(metric: str):
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = METRICS_DIR / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
