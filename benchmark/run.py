"""The benchmark of ``sdr_tpu_torch``, one run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It builds (or finds) the port's CUDA library, makes the cell's traffic
from the seed, warms up the cell's own shapes, measures for ``--seconds``
seconds, checks what the timed path returned against the float64
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics), ``device`` (with ``--trace 1`` also the device's
busy seconds and the traced window), ``breakdown`` with ``--trace 1``,
``build`` (whether this run compiled the port's library, and the seconds
its load took, both inside ``setup_s``), in a listener's cell ``stalls``
(what each block later than its period met: ``harness/stalls.py``),
``pilot_branches`` (per compared row, the pilot PLL's ambiguous decisions
and the blocks that matched a branch of them: ``harness/check.py``), and
last ``checks``: each number compared with its limit, which also close
standard error.  Without a CUDA device it exits 2 and prints no result.

Everything a cell needs is found by the names in ``BENCHMARK.json``
(``harness/cells.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no run may load: JAX and the JAX package
#: (``sdr_tpu_torch`` is another name, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_tpu")
#: the device that a run drives; the tests drive a run on the CPU at a
#: small size by putting "cpu" here and stubbing the card's calls
DEVICE = "cuda"


def _paths_and_caches() -> None:
    """The harness and the port importable; every cache of a build or a
    compiler at a fixed path inside the checkout."""
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def children() -> list[tuple[int, str]]:
    """(pid, command line) of each live child process of this one."""
    me, out = str(os.getpid()), []
    for d in Path("/proc").iterdir():
        try:
            ppid = (d / "stat").read_text().rsplit(")", 1)[1].split()[1]
            if ppid == me:
                cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ")
                out.append((int(d.name), cmd.decode(errors="replace")))
        except (OSError, IndexError):
            continue
    return out


def end_children(grace_s: float = 5.0) -> list[tuple[int, str]]:
    """No child of this run outlives it: any child still alive (none
    should be) is terminated, killed after ``grace_s``, and waited for;
    the ones found are returned."""
    found = children()
    gone = (ProcessLookupError, ChildProcessError)
    for pid, _ in found:
        with contextlib.suppress(*gone):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for pid, _ in found:
        with contextlib.suppress(*gone):
            while not os.waitpid(pid, os.WNOHANG)[0]:
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.01)
    return found


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    return {"nvidia_smi": line}


def _load_library() -> dict:
    """Build (or find) the port's CUDA library and load it: whether this
    run compiled it, and the seconds that took."""
    from sdr_tpu_torch.kernels import build
    compiled = not build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    return {"compiled": compiled, "seconds": time.perf_counter() - t0}


def run(workload: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run of one cell on the card; the result line as a dict."""
    _paths_and_caches()
    import torch

    from harness import cells, check, drivers, stalls, stations, window
    from harness.trace import Trace, reader
    from sdr_tpu_torch.ops import fir_frontend, pll_cuda

    c = cells.cell(workload)
    cfg, mix = c["config"], c["mix"]
    built = _load_library()
    t_built = time.perf_counter()
    ring = stations.make_ring(cfg, mix, seed, DEVICE)
    t_ring = time.perf_counter()
    rows, last = check.sample(seed, mix)
    kept = drivers.Kept(rows, max(last))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rx, shape = drivers.make_receiver(cfg, mix, DEVICE)
    counted = (pll_cuda.pll_angles, pll_cuda.pll_mixer,
               fir_frontend.fir_frontend_u8)
    before = [f.launches for f in counted]
    res = drivers.DRIVERS[mix["driver"]](rx, shape, ring, cfg, mix,
                                         seconds, kept, trace)
    setup_s = res["t_first"] - T_START
    print(f"setup: {setup_s:.3f} s = start, torch and the library "
          f"{t_built - T_START:.3f} s (the library's load "
          f"{built['seconds']:.3f} s, "
          f"{'compiled' if built['compiled'] else 'built before'}), "
          f"traffic {t_ring - t_built:.3f} s, "
          f"receiver and warm-up {res['t_first'] - t_ring:.3f} s",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated()
    k2, k3, k1 = (f.launches - b for f, b in zip(counted, before))
    ran = "K3" if k3 and not k2 else "K2" if k2 and not k3 else "mixed"
    want = mix["expect_pll_kernel"]
    print(f"path: K1 launches {k1}, K2 {k2}, K3 {k3}: the PLL kernel is "
          f"{ran}, the shape selects {want} "
          f"({'as expected' if ran == want else 'NOT as expected'})",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"run.py: the process loaded {bad} (JAX or the "
                         "JAX package); no result")
    del rx
    torch.cuda.empty_cache()

    limit = check.limits(workload)
    t_ref = time.perf_counter()
    refs = check.reference_rows(ring, rows, last, cfg,
                                mix["reference_workers"])
    values = check.compare(kept.arms, refs, last,
                           {n: (v["arm"], v["statistic"])
                            for n, v in limit.items()})
    correct, checks = check.judge(values, limit)
    branches = check.branch_report(kept.arms, refs, last, rows)
    print(f"reference and check: {time.perf_counter() - t_ref:.3f} s; "
          "pilot branches: " + json.dumps(branches), file=sys.stderr)

    if mix["driver"] == "monitor":
        print("chunk seconds: "
              + " ".join(f"{x:.3f}" for x in res["chunk_s"]), file=sys.stderr)
        e2e = {"iq_msps": window.rate_msps(res["samples"], res["t_first"],
                                           res["t_last"])}
        attempted, failed = res["blocks"], 0
    else:
        lat = res["latencies"]
        late_ms = sorted(1e3 * x for x in res["lateness"])
        print(f"submission lateness ms: median {late_ms[len(late_ms) // 2]:.4f}"
              f", p95 {late_ms[int(0.95 * len(late_ms))]:.4f}, max "
              f"{late_ms[-1]:.4f}; latency ms past the period: "
              + " ".join(f"{1e3 * x:.2f}" for x in lat if x > res["period"]),
              file=sys.stderr)
        e2e = {"block_latency_p50_ms": window.percentile_ms(lat, 50),
               "block_latency_p95_ms": window.percentile_ms(lat, 95)}
        attempted, failed = len(lat), window.late(lat, res["period"])
        met = stalls.summary(lat, res["late"], res["passes"], res["usage"],
                             res["probe"])
        print("stalls: " + json.dumps(met), file=sys.stderr)
    e2e["setup_s"] = setup_s

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed}
    if trace:
        t = Trace.from_profiler(res["prof"], res["traced_blocks"], cfg, mix)
        metrics = {}
        for m in c["per_layer"]:
            v = reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        out.update(metrics=metrics, device=dev, breakdown=t.breakdown())
    else:
        out.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                        "unit": m["unit"]}
                            for m in c["end_to_end"]}, device=dev)
    out["card"] = _card()
    out["seed"] = seed
    out["build"] = built
    if mix["driver"] == "listener":
        out["stalls"] = met
    out["pilot_branches"] = branches
    out["checks"] = {a: {k: v if not isinstance(v, float)
                         or math.isfinite(v) else repr(v)
                         for k, v in c.items()} for a, c in checks.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths_and_caches()
    import torch
    from harness import cells
    need = cells.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found; no result",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    left = end_children()
    print("child processes left at the end: "
          + ("; ".join(f"{pid} {cmd}" for pid, cmd in left) or "none"),
          file=sys.stderr)
    for arm, c in out["checks"].items():
        print(f"check {arm} ({c['arm']}, {c['statistic']}): {c['value']!r} "
              f"limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
