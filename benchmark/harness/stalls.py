"""What made a listener block late: the attribution of each block whose
latency ran past its period, from what ``drivers.listener`` recorded
around the window.  Pure: it reads records and does no I/O, so that it
can be checked on synthetic ones.

A block's stall is its latency less the window's median latency: the
time it lost against a block that met nothing.  Its cause is the first
of these that accounts for at least half of the stall:

* ``collector``: the interpreter's collector passes that overlap the
  block's interval from due to done;
* ``throttled``: the cgroup's CPU throttling since the previous reading
  of ``cpu.stat`` (taken at the window's start and after each late
  block, so it may reach back before the block);
* ``faults``: a major page fault, or minor ones with the thread's system
  time, since the previous block was done;
* ``system``: the thread's system time (system calls, the kernel's work
  for it) with no page fault counted, over the same interval;
* ``descheduled``: the thread off its CPU since the previous block was
  done (wall time less its CPU time), whether preempted (involuntary
  switches) or blocked (voluntary ones);
* ``unnamed``: none of these: the thread ran in user mode, in the
  port's host code or waiting on the card; or the block was no slower
  than the median, which is itself past the period.

A block that was due before the previous one was done waited behind it.
Where that wait accounts for half of its stall, it takes the previous
block's cause: one stall makes a run of late blocks, and each of them is
filed under what held the first.
"""

from __future__ import annotations

import numpy as np

CAUSES = ("collector", "throttled", "faults", "system", "descheduled",
          "unnamed")
#: late blocks listed one by one in the record; ``late`` counts them all
KEEP = 20
#: the thread's counters a late block keeps (``resource.getrusage``)
COUNTERS = ("nivcsw", "nvcsw", "minflt", "majflt")


def collector_ms(passes, t0: float, t1: float) -> float:
    """Milliseconds of collector passes inside [t0, t1] on the window's
    clock; ``passes`` holds (generation, start_s, ms, collected)."""
    total = 0.0
    for _, start, ms, _ in passes:
        total += max(0.0, min(t1, start + 1e-3 * ms) - max(t0, start))
    return 1e3 * total


def cause(block: dict, stall_ms: float, before: str | None) -> str:
    """The first cause that accounts for half of ``stall_ms`` (module
    docstring); ``block`` is one entry of :func:`attribute`, ``before``
    the previous block's cause if it was late."""
    half = stall_ms / 2
    if half <= 0:           # no slower than the median: nothing stalled it
        return "unnamed"
    if before is not None and block["queued_ms"] >= half:
        return before
    if block["collector_ms"] >= half:
        return "collector"
    if (block["throttled_usec"] or 0) * 1e-3 >= half:
        return "throttled"
    if block["majflt"] or (block["minflt"] and block["sys_ms"] >= half):
        return "faults"
    if block["sys_ms"] >= half:
        return "system"
    if block["off_cpu_ms"] >= half:
        return "descheduled"
    return "unnamed"


def attribute(late: list[dict], passes, median_s: float) -> list[dict]:
    """Each late block's record, with its cause.  ``late`` holds, per
    late block: ``index``, ``due``, ``done`` (window clock), ``wall_s``,
    ``cpu_s``, ``sys_s`` (since the previous block was done), the
    :data:`COUNTERS` over the same interval, and ``throttle``: the
    change of (nr_throttled, throttled_usec) since the previous reading,
    or None where the cgroup has no ``cpu.stat``."""
    out, causes = [], {}
    for b in late:
        lat = b["done"] - b["due"]
        thr = b["throttle"]
        rec = {"index": b["index"], "latency_ms": 1e3 * lat,
               "queued_ms": 1e3 * max(0.0, b["done"] - b["wall_s"]
                                      - b["due"]),
               "collector_ms": collector_ms(passes, b["due"], b["done"]),
               **{c: b[c] for c in COUNTERS},
               "user_ms": 1e3 * (b["cpu_s"] - b["sys_s"]),
               "sys_ms": 1e3 * b["sys_s"],
               "off_cpu_ms": 1e3 * (b["wall_s"] - b["cpu_s"]),
               "nr_throttled": None if thr is None else thr[0],
               "throttled_usec": None if thr is None else thr[1]}
        rec["cause"] = causes[b["index"]] = cause(
            rec, 1e3 * (lat - median_s), causes.get(b["index"] - 1))
        out.append(rec)
    return out


def summary(latencies_s, late: list[dict], passes, window: dict,
            probe: dict) -> dict:
    """The result line's ``stalls``: the late blocks, counted by cause,
    the collector's full (generation 2) passes in the window, the passes
    and the longest pass of each generation, and the first :data:`KEEP`
    late blocks one by one.  ``window`` holds the thread's CPU and system
    seconds, its :data:`COUNTERS` and the cgroup's throttling over the
    whole window; ``probe`` one full pass timed once the window had
    closed."""
    blocks = attribute(late, passes, float(np.median(latencies_s)))
    full = [ms for gen, _, ms, _ in passes if gen == 2]
    return {"late": len(blocks),
            "by_cause": {c: sum(b["cause"] == c for b in blocks)
                         for c in CAUSES},
            "full_passes": len(full),
            "full_pass_ms_max": max(full) if full else None,
            "full_pass_ms_sum": float(sum(full)),
            "passes": [sum(p[0] == g for p in passes) for g in range(3)],
            "pass_ms_max": [max((p[2] for p in passes if p[0] == g),
                                default=None) for g in range(3)],
            "window": window, "probe": probe, "blocks": blocks[:KEEP]}
