"""Scale-out of the PyTorch port across processes: a mesh that spans them.

Counterpart of ``scripts/multihost_scaling.py`` for ``sdr_tpu_torch``.  It
launches N OS processes, joins them with ``parallel.multihost.setup`` (a
``torch.distributed`` group: gloo on the CPU or when processes share a
card, NCCL when each owns its cards), builds one global mesh with
``multihost.make_mesh`` and runs, in each process, its own part of:

* the **channel mesh** (``worker_main``): ``channel_sharded_run`` of raw u8
  channels, each process passing its own rows, nothing exchanged; each
  process's rows are held against a one-process run of the same rows;
* the **time axis** (``worker_time_axis``): ``time_sharded_receive`` of a
  synthesized station on a (channel x time) mesh whose time rows live on
  one process each (the halo stays inside it: K6), or, with
  ``--cross-halo``, span the processes (every halo crosses the process
  edge as point-to-point messages).  Outputs are gathered across the
  processes, as the JAX worker's ``process_allgather`` does, and held
  against a contiguous run of the same channel.

Each worker writes ``result_<rank>.json`` (the JAX script's keys where they
apply: ``mesh_shape``, ``halo_intra_process``,
``fm_max_abs_err_vs_contiguous``, ``mono_rel_rms_vs_contiguous``,
``samples_per_s``; plus its kernels' launches, and the time per call of
the edge exchange and of K6).  The captures come from one file that the
orchestrator writes (:func:`make_capture`), so that every process and the
caller hold the same signal.  Run from the repository root:

    python scripts/torch_multihost_scaling.py --device cpu
    python scripts/torch_multihost_scaling.py --device cuda           # 2 processes on cuda:0
    python scripts/torch_multihost_scaling.py --device cuda --cards 1 # cuda:0 and cuda:1

The orchestrator builds the CUDA kernels and the native library before it
spawns, so that the processes do not build them twice.  It imports no jax.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sdr_tpu_torch import config as cfg  # noqa: E402
from sdr_tpu_torch.models import receiver as rx  # noqa: E402
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda  # noqa: E402
from sdr_tpu_torch.parallel import Mesh, channel_sharded_run  # noqa: E402
from sdr_tpu_torch.parallel import gather_channels, multihost  # noqa: E402
from sdr_tpu_torch.parallel import halo as khalo  # noqa: E402
from sdr_tpu_torch.parallel import time_shard  # noqa: E402
from sdr_tpu_torch.utils import synth  # noqa: E402

MODE = 0
PEER_TIMEOUT = datetime.timedelta(seconds=300)   # a worker awaits its peers
ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")
COUNTERS = {"fir_frontend_u8": fir_frontend.fir_frontend_u8,
            "pll_angles": pll_cuda.pll_angles,
            "pll_mixer": pll_cuda.pll_mixer,
            "fir_decim_i8": fir_frontend.fir_frontend_u8_deinterleaved,
            "fir_decim_f32": fir_decim.fir_block_decim,
            "halo_shift_right": khalo.halo_shift_right}


# --- captures -----------------------------------------------------------------


def write_capture(path: Path, iq_u8: np.ndarray, rows: int,
                  n_bytes: int) -> None:
    """Write ``rows`` rows of ``n_bytes`` raw bytes of one capture to
    ``path`` (``.npz``): row r starts at the r-th of ``rows`` whole-I/Q-pair
    offsets spread evenly over what the capture leaves beyond one row."""
    spare = len(iq_u8) - n_bytes
    if spare < 0:
        raise ValueError(f"a capture of {len(iq_u8)} bytes is shorter than "
                         f"a row of {n_bytes}")
    offsets = np.linspace(0, spare, rows).astype(np.int64) // 2 * 2
    np.savez(path, iq_u8=iq_u8, offsets=offsets, n_bytes=n_bytes)


def make_capture(path: Path, rows: int, n_bytes: int, seed: int,
                 rds: bool = True, spare_s: float = 0.05
                 ) -> synth.SynthResult:
    """Synthesize one mode-0 stereo station ``spare_s`` seconds longer than
    a row of ``n_bytes`` raw bytes and write ``rows`` rows of it to
    ``path`` (:func:`write_capture`).  Returns the synthesis (its RDS
    groups are what every row transmits)."""
    mc = cfg.get_mode_config(MODE)
    res = synth.synthesize_fm(duration_s=n_bytes / 2 / mc.rf_fs + spare_s,
                              mode=MODE, seed=seed, with_rds=rds)
    write_capture(path, res.iq_u8, rows, n_bytes)
    return res


def capture_rows(path: Path, rows: range) -> np.ndarray:
    """Rows ``rows`` of the capture at ``path``, (len(rows), n_bytes) u8."""
    with np.load(path) as z:
        iq, offs, n = z["iq_u8"], z["offsets"], int(z["n_bytes"])
    return np.stack([iq[offs[r]:offs[r] + n] for r in rows])


# --- workers -------------------------------------------------------------------


def _local_devices(a: argparse.Namespace) -> list[str]:
    """This process's mesh entries: ``--local-devices`` of them, on the
    CPU, on cuda:0 shared by every process (``--cards 0``), or spread
    over the process's own ``--cards`` cards."""
    if a.device == "cpu":
        return ["cpu"] * a.local_devices
    if a.cards == 0:
        return ["cuda:0"] * a.local_devices
    first = a.process_id * a.cards
    return [f"cuda:{first + i * a.cards // a.local_devices}"
            for i in range(a.local_devices)]


def _join(a: argparse.Namespace) -> list[str]:
    if a.device == "cpu":
        torch.set_num_threads(1)
    devices = _local_devices(a)
    multihost.setup(a.init_method, a.num_processes, a.process_id,
                    devices=devices, timeout=PEER_TIMEOUT)
    rx.pin_fp32_matmul()
    return devices


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    khalo.halo_shift_right.row_block_launches = 0
    time_shard.exchange_edges.messages = 0


def _wall(run, device: str):
    """``run()``'s result and its host wall, ending in a synchronize, all
    processes starting together."""
    dist.barrier()
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    return out, time.perf_counter() - t0


def _measured(run, rounds: int, device: str) -> tuple:
    """(result of the first call, the kernels' launches in it, counted from
    0, the best wall of ``rounds`` calls)."""
    _reset_counts()
    out, wall = _wall(run, device)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    counts["halo_row_blocks"] = khalo.halo_shift_right.row_block_launches
    counts["edge_messages"] = time_shard.exchange_edges.messages
    for _ in range(rounds - 1):
        wall = min(wall, _wall(run, device)[1])
    return out, counts, wall


def _write(a: argparse.Namespace, result: dict) -> None:
    with open(Path(a.outdir) / f"result_{a.process_id}.json", "w") as f:
        json.dump(result, f)


def worker_main(a: argparse.Namespace) -> None:
    """Channel mesh: this process's ``--ch-per-proc`` raw u8 rows through
    ``channel_sharded_run`` over the global mesh, against a one-process
    run of the same rows."""
    devices = _join(a)
    mesh = multihost.make_mesh(time_per_host=len(devices), devices=devices)
    halo_local = all(len(set(row)) == 1 for row in mesh.ranks)
    mc = cfg.get_mode_config(MODE)
    bs = a.block_if * 2 * mc.rf_decim if a.block_if else \
        mc.default_block_size(a.rds)
    c_p = a.ch_per_proc
    iq = capture_rows(Path(a.capture), range(a.process_id * c_p,
                                             (a.process_id + 1) * c_p))
    iq = np.ascontiguousarray(iq[:, :a.blocks * bs])
    kw = dict(stereo=True, with_rds=a.rds, block_size=bs)

    shards, launches, wall = _measured(
        lambda: channel_sharded_run(iq, mesh, MODE, **kw), a.rounds,
        devices[0])
    outs, _ = gather_channels(shards)
    ref, _ = gather_channels(channel_sharded_run(
        iq, Mesh([devices[0]], ("ch",)), MODE, **kw))
    errs = {arm: float((getattr(outs, arm) - getattr(ref, arm)).abs().max())
            for arm in ARMS if getattr(ref, arm).numel()}
    _write(a, {
        "process_id": a.process_id, "num_processes": a.num_processes,
        "local_devices": len(devices), "global_devices": mesh.size,
        "backend": dist.get_backend(), "device": devices[0],
        "mesh_shape": mesh.shape, "channels_global": mesh.shape["ch"] * c_p,
        "halo_confined_to_host": bool(halo_local),
        "wall_s": wall, "samples_per_s": a.blocks * (bs // 2) * c_p / wall,
        "max_abs_err_vs_one_process": errs, "launches": launches})


def _per_call_ms(fn, reps: int, device: str) -> float:
    """Milliseconds per call of ``fn``: CUDA events on a card, the host
    clock on the CPU."""
    fn()
    _sync(device)
    if device.startswith("cuda"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _edge_and_k6_ms(mesh: Mesh, dev: str, halo: int, seg: int,
                    reps: int) -> tuple[float | None, float]:
    """Per call, after one untimed call: the edge exchange of this
    process's halos (host clock around each call, which ends in a
    synchronize; None where no halo crosses), and K6 over its cells as ``time_sharded_receive`` lays them
    out on one device (CUDA events)."""
    sends, recvs = time_shard.edge_peers(mesh, "time", "ch")
    rows, cols = mesh.local_cells("time", "ch")
    edge_ms = None
    dist.barrier()
    if sends or recvs:
        tails = [(torch.randn(1, halo, device=dev), peer, b)
                 for b, peer in sends]
        slots = [(torch.empty(1, halo, device=dev), peer, b)
                 for b, peer in recvs]
        time_shard.exchange_edges(tails, slots)        # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            time_shard.exchange_edges(tails, slots)
            _sync(dev)
        edge_ms = (time.perf_counter() - t0) / reps * 1e3
    buf = torch.zeros((len(rows), len(cols), 1, halo + seg), device=dev)
    k6_ms = _per_call_ms(lambda: khalo.halo_shift_right(buf, halo), reps,
                         dev)
    return edge_ms, k6_ms


def _gather(local: dict, rows: range, cols: range, shape: tuple) -> dict:
    """Every process's (rows, cols) part of each arm, assembled into the
    global (B, S*T) layout on every process."""
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (rows, cols, local))
    out = {}
    for arm in local:
        t = local[arm].shape[-1] // len(cols)
        full = np.empty((shape[0], shape[1] * t), np.float32)
        for r, k, part in parts:
            full[r.start:r.stop, k.start * t:k.stop * t] = part[arm]
        out[arm] = full
    return out


def worker_time_axis(a: argparse.Namespace) -> None:
    """Time axis: ``time_sharded_receive`` over the global (ch x time)
    mesh, this process passing its rows over its time span; outputs
    gathered and held against a contiguous run of one channel."""
    devices = _join(a)
    mesh = multihost.make_mesh(time_per_host=len(devices),
                               cross_process_time=a.cross_halo,
                               devices=devices)
    halo_intra_process = all(len(set(row)) == 1
                             for row in mesh.rank_grid("time", "ch"))
    mc = cfg.get_mode_config(MODE)
    block_if = a.block_if or time_shard.default_block_if(mc, a.rds)
    block_raw = block_if * 2 * mc.rf_decim
    b_rows, s = mesh.shape["ch"], mesh.shape["time"]
    seg = a.blocks * block_raw
    rows, cols = mesh.local_cells("time", "ch")
    iq = synth.u8_to_float(capture_rows(Path(a.capture), rows)[
        :, cols.start * seg:cols.stop * seg])
    kw = dict(stereo=True, with_rds=a.rds, batch_axis="ch",
              block_if=block_if, overlap_if=a.overlap_if)

    out, launches, wall = _measured(
        lambda: time_shard.time_sharded_receive(iq, mesh, MODE, **kw),
        a.rounds, devices[0])
    halo = time_shard.halo_raw(mc, block_if, a.overlap_if)
    edge_ms, k6_ms = _edge_and_k6_ms(mesh, devices[0], halo, seg, a.reps)

    local = {arm: getattr(out, arm).cpu().numpy() for arm in ARMS
             if getattr(out, arm).numel()}
    full = _gather(local, rows, cols, (b_rows, s))
    if a.save_outputs and a.process_id == 0:
        np.savez(Path(a.outdir) / "outputs.npz", **full)
    # the row this process validates, as the JAX worker does
    row = a.process_id % b_rows
    ref = rx.Receiver(MODE, stereo=True, with_rds=a.rds,
                      device=devices[0]).run(
        synth.u8_to_float(capture_rows(Path(a.capture),
                                       range(row, row + 1))[0, :s * seg]),
        block_size=block_raw)
    ref_fm = ref.fm_demod.reshape(-1).cpu().numpy()
    ref_mono = ref.mono.reshape(-1).cpu().numpy()
    d = full["mono"][row] - ref_mono
    _write(a, {
        "process_id": a.process_id, "num_processes": a.num_processes,
        "local_devices": len(devices), "global_devices": mesh.size,
        "backend": dist.get_backend(), "device": devices[0],
        "mesh_shape": mesh.shape,
        "halo_intra_process": bool(halo_intra_process),
        "cross_halo_requested": bool(a.cross_halo),
        "cells": [list(rows), list(cols)],
        "wall_s": wall, "samples_per_s": iq.size / 2 / wall,
        "fm_max_abs_err_vs_contiguous": float(
            np.abs(full["fm_demod"][row] - ref_fm).max()),
        "mono_rel_rms_vs_contiguous": float(
            np.sqrt(np.mean(d ** 2)) / max(np.sqrt(np.mean(ref_mono ** 2)),
                                           1e-30)),
        "launches": launches, "edge_messages": launches["edge_messages"],
        "halo_raw": halo, "edge_ms": edge_ms, "k6_ms": k6_ms})


# --- orchestration --------------------------------------------------------------


def prebuild(device: str) -> None:
    """Build what the processes load, once, before they start: the CUDA
    kernels on a card and the native host library.  Raises RuntimeError
    for ``device="cuda"`` on a machine without a card: the processes run
    on the CPU only when the caller asks for it."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run the processes on the CPU")
    import sdr_tpu_torch.native  # noqa: F401  (builds on import)
    if device == "cuda":
        from sdr_tpu_torch.kernels import build
        build.load()


def spawn(kind: str, n_procs: int, outdir: Path, args: list[str],
          timeout_s: float) -> list[dict]:
    """Run ``n_procs`` workers of ``kind`` ("ch" or "time") with ``args``,
    rendezvous through a file in ``outdir``; returns their results in rank
    order.  Raises RuntimeError, with the end of the failing worker's log,
    when one exits non-zero or the configuration outlives ``timeout_s``
    (every worker is then killed)."""
    outdir.mkdir(parents=True, exist_ok=True)
    store = outdir / "store"
    store.unlink(missing_ok=True)
    procs, logs = [], []
    for pid in range(n_procs):
        log = open(outdir / f"worker_{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", kind,
             "--init-method", f"file://{store}", "--num-processes",
             str(n_procs), "--process-id", str(pid), "--outdir", str(outdir),
             *args], cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)
        raise RuntimeError(f"{kind} configuration of {n_procs} processes "
                           f"timed out after {timeout_s} s")
    finally:
        for log in logs:
            log.close()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            tail = (outdir / f"worker_{pid}.log").read_text()[-4000:]
            raise RuntimeError(f"{kind} worker {pid} exited {p.returncode}:"
                               f"\n{tail}")
    return [json.loads((outdir / f"result_{pid}.json").read_text())
            for pid in range(n_procs)]


def _common(device: str, local_devices: int, cards: int, rds: bool,
            block_if: int | None, blocks: int, rounds: int,
            capture: Path) -> list[str]:
    args = ["--device", device, "--local-devices", str(local_devices),
            "--cards", str(cards), "--blocks", str(blocks),
            "--rounds", str(rounds), "--capture", str(capture)]
    if rds:
        args.append("--rds")
    if block_if:
        args += ["--block-if", str(block_if)]
    return args


def run_config(outdir: Path, n_procs: int = 2, local_devices: int = 1,
               device: str = "cuda", cards: int = 0, ch_per_proc: int = 4,
               rds: bool = False, block_if: int | None = None,
               blocks: int = 4, rounds: int = 2,
               capture: Path | None = None, timeout_s: float = 600.0
               ) -> dict:
    """The channel mesh over ``n_procs`` processes of ``local_devices``
    mesh entries, on the card unless ``device="cpu"``: per-process
    results and their aggregate."""
    prebuild(device)
    outdir.mkdir(parents=True, exist_ok=True)
    if capture is None:
        mc = cfg.get_mode_config(MODE)
        bs = block_if * 2 * mc.rf_decim if block_if else \
            mc.default_block_size(rds)
        capture = outdir / "capture.npz"
        make_capture(capture, n_procs * ch_per_proc, blocks * bs, seed=1000,
                     rds=rds)
    results = spawn("ch", n_procs, outdir,
                    _common(device, local_devices, cards, rds, block_if,
                            blocks, rounds, capture)
                    + ["--ch-per-proc", str(ch_per_proc)], timeout_s)
    return {"num_processes": n_procs,
            "local_devices_per_process": local_devices,
            "global_devices": results[0]["global_devices"],
            "channels_global": results[0]["channels_global"],
            "backend": results[0]["backend"],
            "halo_confined_to_host": all(r["halo_confined_to_host"]
                                         for r in results),
            "wall_s": max(r["wall_s"] for r in results),
            "aggregate_samples_per_s": sum(r["samples_per_s"]
                                           for r in results),
            "results": results}


def run_time_axis(outdir: Path, n_procs: int = 2, local_devices: int = 2,
                  device: str = "cuda", cards: int = 0, cross: bool = False,
                  rds: bool = False, block_if: int | None = None,
                  blocks: int = 6, overlap_if: int | None = None,
                  rounds: int = 2, reps: int = 10,
                  capture: Path | None = None,
                  save_outputs: bool = False, timeout_s: float = 900.0
                  ) -> dict:
    """The time-sharded receiver over ``n_procs`` processes of
    ``local_devices`` mesh entries, ``blocks`` blocks a shard, the halo
    inside each process or (``cross``) across the process edge, on the
    card unless ``device="cpu"``.  The capture holds a row per channel of
    the mesh."""
    prebuild(device)
    outdir.mkdir(parents=True, exist_ok=True)
    if capture is None:
        mc = cfg.get_mode_config(MODE)
        block_raw = (block_if or time_shard.default_block_if(mc, rds)) \
            * 2 * mc.rf_decim
        rows = local_devices if cross else n_procs
        n = blocks * block_raw * (n_procs if cross else local_devices)
        capture = outdir / "capture.npz"
        make_capture(capture, rows, n, seed=2000, rds=rds)
    args = _common(device, local_devices, cards, rds, block_if, blocks,
                   rounds, capture) + ["--reps", str(reps)]
    if cross:
        args.append("--cross-halo")
    if overlap_if:
        args += ["--overlap-if", str(overlap_if)]
    if save_outputs:
        args.append("--save-outputs")
    results = spawn("time", n_procs, outdir, args, timeout_s)
    return {"num_processes": n_procs,
            "local_devices_per_process": local_devices,
            "cross_halo": cross, "backend": results[0]["backend"],
            "mesh_shape": results[0]["mesh_shape"],
            "halo_intra_process": all(r["halo_intra_process"]
                                      for r in results),
            "wall_s": max(r["wall_s"] for r in results),
            "aggregate_samples_per_s": sum(r["samples_per_s"]
                                           for r in results),
            "fm_max_abs_err_vs_contiguous": max(
                r["fm_max_abs_err_vs_contiguous"] for r in results),
            "mono_rel_rms_vs_contiguous": max(
                r["mono_rel_rms_vs_contiguous"] for r in results),
            "results": results}


def orchestrate(a: argparse.Namespace) -> dict:
    """The four configurations of ``scripts/multihost_scaling.py``'s
    multi-process cases: the channel mesh over 2 x 1 and 2 x 2 mesh
    entries, the time axis with the halo local and across the edge."""
    root = Path(tempfile.mkdtemp(prefix="sdr_torch_scaling_"))
    kw = dict(device=a.device, cards=a.cards, rds=a.rds, block_if=a.block_if, blocks=a.blocks,
              rounds=a.rounds)
    report = {
        "channel_2proc": run_config(root / "ch1", 2, 1,
                                    ch_per_proc=a.ch_per_proc, **kw),
        "channel_2proc_2dev": run_config(root / "ch2", 2, 2,
                                         ch_per_proc=a.ch_per_proc, **kw),
        "time_axis_2proc": run_time_axis(root / "t", 2, 2, **kw),
        "time_axis_2proc_cross_halo": run_time_axis(root / "tx", 2, 2,
                                                    cross=True, **kw)}
    report["cross_halo_slowdown"] = (
        report["time_axis_2proc_cross_halo"]["wall_s"]
        / max(report["time_axis_2proc"]["wall_s"], 1e-12))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", choices=["ch", "time"])
    ap.add_argument("--init-method", dest="init_method")
    ap.add_argument("--num-processes", type=int, dest="num_processes")
    ap.add_argument("--process-id", type=int, dest="process_id", default=0)
    ap.add_argument("--outdir")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--cards", type=int, default=0,
                    help="cards per process; 0: every process on cuda:0")
    ap.add_argument("--local-devices", type=int, default=1,
                    dest="local_devices")
    ap.add_argument("--capture")
    ap.add_argument("--ch-per-proc", type=int, default=4, dest="ch_per_proc")
    ap.add_argument("--rds", action="store_true")
    ap.add_argument("--block-if", type=int, dest="block_if")
    ap.add_argument("--overlap-if", type=int, dest="overlap_if")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cross-halo", action="store_true", dest="cross_halo")
    ap.add_argument("--save-outputs", action="store_true",
                    dest="save_outputs")
    ap.add_argument("--out", help="write the report here as JSON")
    a = ap.parse_args(argv)
    if a.worker:
        try:
            (worker_main if a.worker == "ch" else worker_time_axis)(a)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    else:
        report = orchestrate(a)
        text = json.dumps(report, indent=2)
        if a.out:
            Path(a.out).write_text(text)
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
