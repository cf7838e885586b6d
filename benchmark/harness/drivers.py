"""The two traffic drivers: the monitor's closed loop over
``Receiver.iter_run`` and the listener's open loop over
``Receiver.process``.  A traffic file names its driver and gives its
parameters; nothing here belongs to one cell.

Each driver warms up the cell's own shapes, puts the receiver back to a
fresh stream (a zero state), then runs the window and returns what it
measured and the host outputs of the blocks that the check compares.
"""

from __future__ import annotations

import contextlib
import gc
import math
import resource
import time
from pathlib import Path

import numpy as np

from harness.stalls import COUNTERS

clock = time.perf_counter


def _span(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _fresh(rx, batch_shape) -> None:
    """Back to the start of a stream: the next call copies a zero state
    into the program's state buffers."""
    from sdr_tpu_torch.models.receiver import init_state
    rx.state = init_state(rx.mc, batch_shape, device=rx.device)


def make_receiver(cfg: dict, mix: dict, device):
    from sdr_tpu_torch.models.receiver import Receiver
    shape = (mix["channels"],) if mix["driver"] == "monitor" else ()
    rx = Receiver(mode=cfg["mode"], stereo=cfg["stereo"],
                  with_rds=cfg["rds"], batch_shape=shape, device=device)
    if rx.mc.default_block_size(rx.with_rds) != cfg["block_bytes"]:
        raise RuntimeError("the port's block size for mode "
                           f"{cfg['mode']} is not {cfg['block_bytes']}")
    return rx, shape


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Kept:
    """The host outputs of the compared rows for stream blocks
    0..last: ``arms[name]`` is a list of (rows, length) arrays, one per
    block, in stream order."""

    def __init__(self, rows: list[int], last: int):
        self.rows, self.last = rows, last
        self.arms: dict[str, list[np.ndarray]] = {}

    def add(self, outs: dict, first_block: int) -> None:
        """``outs[arm]`` (blocks, rows, length) for stream blocks from
        ``first_block`` on, rows already picked."""
        for arm, a in outs.items():
            have = self.arms.setdefault(arm, [])
            for b in range(a.shape[0]):
                if first_block + b <= self.last:
                    have.append(np.array(a[b]))

    def done(self, next_block: int) -> bool:
        return next_block > self.last


def monitor(rx, shape, ring: np.ndarray, cfg: dict, mix: dict,
            seconds: float, kept: Kept, trace: bool) -> dict:
    """Closed loop: each ``iter_run`` call streams the whole ring
    (``ring_blocks`` blocks, ``chunk_blocks`` a chunk) and the next chunk
    is submitted once the previous one's outputs are host numpy; the
    state carries from chunk to chunk, so the stream wraps the ring."""
    import torch
    k = mix["chunk_blocks"]
    for _ in rx.iter_run(ring, chunk_blocks=k):
        pass
    _sync(rx.device)
    _fresh(rx, shape)
    prof, traced, chunk_s = None, 0, []
    chunks = 0
    t_first = t_last = clock()
    while True:
        if (trace and prof is None and chunks >= mix["trace_skip_chunks"]
                and (clock() - t_first + mix["trace_chunks"]
                     * np.mean(chunk_s) >= seconds)):
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            window = torch.profiler.record_function("traced_window")
            window.__enter__()
        for outs in rx.iter_run(ring, chunk_blocks=k):
            t_prev, t_last = t_last, clock()
            chunk_s.append(t_last - t_prev)
            if not kept.done(chunks * k):
                kept.add({a: getattr(outs, a)[:, kept.rows]
                          for a in outs._fields
                          if getattr(outs, a).shape[-1]}, chunks * k)
            chunks += 1
            if prof is not None:
                traced += 1
        if prof is not None and traced >= mix["trace_chunks"]:
            _sync(rx.device)
            window.__exit__(None, None, None)
            prof.stop()
            break
        if (not trace and t_last - t_first >= seconds
                and kept.done(chunks * k)):
            break
    channels = mix["channels"]
    return {"t_first": t_first, "t_last": t_last, "chunks": chunks,
            "blocks": chunks * k,
            "samples": chunks * k * channels * cfg["block_bytes"] // 2,
            "prof": prof, "traced_blocks": traced * k, "chunk_s": chunk_s}


def _wait_until(t: float) -> float:
    """Spin until ``t``, so that a block is submitted when it is due and
    not when the scheduler wakes a sleeper (a sleep overshot by up to 8 ms
    on the card's host); returns how late the submission is."""
    while (now := clock()) < t:
        pass
    return now - t


class CollectorLog:
    """Each pass of the interpreter's collector while it is installed in
    ``gc.callbacks``: its generation, its start on ``clock``, its
    milliseconds and the objects it collected.  It appends numbers to
    flat lists and does nothing else, so that the record makes nothing
    that the collector tracks."""

    def __init__(self):
        self.gen, self.start, self.ms, self.collected = [], [], [], []
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = clock()
            return
        self.ms.append(1e3 * (clock() - self._t))
        self.gen.append(info["generation"])
        self.start.append(self._t)
        self.collected.append(info["collected"])

    def passes(self) -> list[tuple]:
        """(generation, start_s, ms, collected) of each pass."""
        return list(zip(self.gen, self.start, self.ms, self.collected))


def _usage() -> tuple:
    """This thread's CPU seconds (its own clock, which ``getrusage`` may
    lag by a scheduler tick; both at the kernel's resolution, which may
    be a tick), its system seconds, then ``stalls.COUNTERS`` (zero where
    the kernel does not count them)."""
    r = resource.getrusage(resource.RUSAGE_THREAD)
    return (time.thread_time(), r.ru_stime, r.ru_nivcsw, r.ru_nvcsw,
            r.ru_minflt, r.ru_majflt)


def _usage_delta(u1: tuple, u0: tuple) -> dict:
    d = [a - b for a, b in zip(u1, u0)]
    return {"cpu_s": d[0], "sys_s": d[1], **dict(zip(COUNTERS, d[2:]))}


def cpu_stat_path() -> Path | None:
    """The cgroup's ``cpu.stat`` (cgroup v2) that counts throttling, or
    None."""
    try:
        lines = Path("/proc/self/cgroup").read_text().splitlines()
    except OSError:
        return None
    for line in lines:
        if line.startswith("0::"):
            f = Path("/sys/fs/cgroup") / line[3:].lstrip("/") / "cpu.stat"
            with contextlib.suppress(OSError):
                if "nr_throttled" in f.read_text():
                    return f
    return None


def throttling(path: Path | None) -> tuple[int, int] | None:
    """(nr_throttled, throttled_usec) of the cgroup, read-only, or None."""
    if path is None:
        return None
    try:
        kv = dict(line.split()[:2] for line in path.read_text().splitlines())
        return int(kv["nr_throttled"]), int(kv["throttled_usec"])
    except (OSError, ValueError, KeyError):
        return None


def _throttle_delta(t1, t0):
    return None if t1 is None or t0 is None else (t1[0] - t0[0],
                                                  t1[1] - t0[1])


def listener(rx, shape, ring: np.ndarray, cfg: dict, mix: dict,
             seconds: float, kept: Kept, trace: bool) -> dict:
    """Open loop at the signal's own rate: block k is due at t0 + k x
    the block's duration, whatever happened to block k-1, and its
    latency runs from when it was due to when every arm it returned is
    host numpy.

    Around the window it records what a late block met (``stalls``):
    the collector's passes (:class:`CollectorLog`), this thread's
    ``getrusage`` read after each block is done, outside its timed
    interval, and the cgroup's throttling at the window's edges and
    after each late block.  Once the window has closed it times one full
    collection, as a probe of what a pass costs on this host."""
    import torch
    bs = cfg["block_bytes"]
    period = bs / 2 / cfg["rf_fs"]
    row = ring[0]
    blocks = [row[b * bs:(b + 1) * bs] for b in range(mix["ring_blocks"])]
    for b in range(mix["warm_blocks"]):
        out = rx.process(blocks[b % len(blocks)])
        [a.cpu().numpy() for a in out]
    _sync(rx.device)
    _fresh(rx, shape)
    n_due = max(math.ceil(seconds / period), kept.last + 1)
    prof, first_traced = None, n_due
    if trace:
        first_traced = max(n_due - mix["trace_blocks"], kept.last + 1)
        n_due = max(n_due, first_traced + mix["trace_blocks"])
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(
                wait=0, warmup=first_traced, active=n_due - first_traced,
                repeat=1))
        prof.__enter__()
    latencies, lateness = [], []
    log, late, cpu_stat = CollectorLog(), [], cpu_stat_path()
    thr_first = thr_prev = throttling(cpu_stat)
    gc.callbacks.append(log)
    try:
        u_first = u_prev = _usage()
        t0 = t_prev = clock()
        window = None
        for k in range(n_due):
            if k == first_traced:
                window = torch.profiler.record_function("traced_window")
                window.__enter__()
            due = t0 + k * period
            with _span(trace, "schedule_wait"):
                lateness.append(_wait_until(due))
            with _span(trace, "entry_call"):
                out = rx.process(blocks[k % len(blocks)])
            with _span(trace, "fetch"):
                host = {a: getattr(out, a).cpu().numpy() for a in out._fields}
            done = clock()
            latencies.append(done - due)
            u = _usage()
            if done - due > period:
                thr = throttling(cpu_stat)
                late.append({"index": k, "due": due, "done": done,
                             "wall_s": done - t_prev,
                             **_usage_delta(u, u_prev),
                             "throttle": _throttle_delta(thr, thr_prev)})
                thr_prev = thr
            u_prev, t_prev = u, done
            if not kept.done(k):
                kept.add({a: v[None, None] for a, v in host.items()
                          if v.shape[-1]}, k)
            if prof is not None:
                if k == n_due - 1:
                    _sync(rx.device)
                    window.__exit__(None, None, None)
                prof.step()
    finally:
        gc.callbacks.remove(log)
    thr = _throttle_delta(throttling(cpu_stat), thr_first)
    usage = _usage_delta(u_prev, u_first)
    usage["nr_throttled"], usage["throttled_usec"] = thr or (None, None)
    if prof is not None:
        prof.__exit__(None, None, None)
    tracked = len(gc.get_objects())
    t = clock()
    collected = gc.collect()
    probe = {"full_pass_ms": 1e3 * (clock() - t), "tracked": tracked,
             "collected": collected}
    return {"t_first": t0, "latencies": latencies, "lateness": lateness,
            "blocks": n_due,
            "period": period, "prof": prof,
            "traced_blocks": n_due - first_traced if trace else 0,
            "late": late, "passes": log.passes(), "usage": usage,
            "probe": probe}


DRIVERS = {"monitor": monitor, "listener": listener}
