#!/usr/bin/env python3
"""Time the port's FIR kernels (K1, K4, K5), its halo exchange (K6) and
the blocks they run in, on one card.

For comparing two versions of ``sdr_tpu_torch`` in one call, in turns: the
package is taken from ``PYTHONPATH``, so the same script times any tree
with the same public functions (``fir_frontend.fir_frontend_u8``,
``fir_frontend_u8_deinterleaved``, ``fir_decim.fir_block_decim``,
``halo.halo_shift_right``, ``Channelizer``, ``Receiver``,
``time_sharded_receive``)::

    git archive HEAD | tar -x -C build/parent     # the parent, gitignored
    for t in parent change change parent; do
      PYTHONPATH=$([ $t = parent ] && echo build/parent || echo .) \\
        python3 scripts/torch_fir_halo_ab.py --label $t
    done

Prints one line per measurement and a JSON line with all of them
(``--parts`` picks them, by default all):

* ``k1``: K1, the u8 front-end, at C=1 and C=512 (one 115,200-byte
  block a channel): the whole call by CUDA events over 20 back-to-back
  calls and the kernel's device time under ``torch.profiler``, beside
  ``conv1d`` at stride 10 over the normalized, deinterleaved [state |
  block] (made outside the timing, TF32 off), the library yardstick;
* ``k4``: K4, the int8 form of the same function, at C=1 and C=512: the
  call and its FIR kernel's device time;
* K5 at the paths' six shapes (the float front-end at C=1 and C=512, the
  channelizer at C=2 and C=64 with D=4 and D=8): CUDA events over 20
  back-to-back calls, and the kernel's device time under
  ``torch.profiler``, beside ``conv1d`` at stride D over [state | block]
  (TF32 off), the library yardstick;
* K6 at S=8 shards of mode 0's RDS halo (230,400) with C=1 and C=4 rows,
  called as ``time_sharded_receive`` calls it on one card (a tree with the
  row-block entry: the (1, S, C, L) tensor; else the S row views): the
  whole call by CUDA events over 50 back-to-back calls (the tails then sit
  in L2), and the kernel's own device duration under ``torch.profiler``
  with L2 flushed before each launch (a 64 MB write); beside one ``copy_``
  of the tails into the prefixes;
* the wideband block, C=64 stations at 19.2 MS/s (channelizer + receiver
  on random u8): wall by CUDA events, and under ``torch.profiler`` device
  busy (the union of kernel and memcpy intervals), idle share 1 - busy /
  wall, and K5's device time;
* ``block``: the mode-0 stereo+RDS block on random u8 at C=1 and C=512:
  wall per block by CUDA events over back-to-back blocks, and under
  ``torch.profiler`` device busy, idle share, device events per block
  and K1's device time;
* one time-sharded step at S=8 (``process_block`` over the 8 shards' rows
  of one 115,200-sample float block, the step ``time_sharded_receive``
  repeats): the same three numbers; and a whole ``time_sharded_receive``
  of a 4 s capture at S=8 by host clock.

The card's name and power limit come first.  Needs one NVIDIA GPU.
Under ``torch.profiler`` a kernel's device time is the union of the device
intervals of the kernels whose name holds the part's match (``fir_``:
every FIR kernel of the port, of either tree).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SEED = 20261016
SHARDS = 8


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(intervals: list[tuple[float, float]]) -> float:
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


def profiled(fn, reps: int, match: str) -> dict:
    """Device busy per call, the device time of kernels whose name holds
    ``match`` per call, and device events per call, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # a span's device side (``utils.profiling.span``) is an annotation
    # over the kernels it launched, not work
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    span = lambda es: busy_ms([(e.time_range.start, e.time_range.end)
                               for e in es])
    return {"busy_ms": span(dev) / reps,
            "kernel_ms": span([e for e in dev if match in e.name]) / reps,
            "events": len(dev) / reps}


def k5_cases(rng):
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.models.channelizer import Channelizer

    mc = rx.cfg.get_mode_config(0)
    n = mc.default_block_size(True) // 2                 # 57,600 I/Q pairs
    f32 = lambda shape: torch.tensor(rng.standard_normal(shape),
                                     dtype=torch.float32, device="cuda")
    h_rf = rx.design_coeffs(mc, device="cuda").rf
    for c in (1, 512):
        x = f32((c, 2 * n)).reshape(c, n, 2).movedim(-1, -2)
        yield f"front-end C={c}", x, h_rf, f32((c, 2, 150)), mc.rf_decim
    for d in (4, 8):
        h = Channelizer((0.0,), d * mc.rf_fs, 0, device="cuda").coeffs
        for c in (2, 64):
            yield (f"channelizer C={c} D={d}", f32((c, 2, d * n)), h,
                   f32((c, 2, h.shape[0] - 1)), d)


def time_k5(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.ops import fir_decim

    for name, x, h, st, d in k5_cases(rng):
        ms = cuda_ms(lambda: fir_decim.fir_block_decim(x, h, st, d), 20)
        rows = x.shape[0] * x.shape[1]
        inp = torch.cat([st, x], dim=-1).reshape(rows, 1, -1).contiguous()
        w = h.flip(0).reshape(1, 1, -1).contiguous()
        lib = cuda_ms(lambda: torch.nn.functional.conv1d(inp, w, stride=d),
                      20)
        dev = profiled(lambda: fir_decim.fir_block_decim(x, h, st, d), 10,
                       "fir_")["kernel_ms"]
        res[f"K5 {name}"] = {"ms": ms, "kernel_ms": dev, "conv1d_ms": lib}
        print(f"[{label}] K5 {name}: {ms:.4f} ms (kernel alone {dev:.4f} "
              f"ms), conv1d {lib:.4f} ms")


def u8_cases(rng):
    """The u8 front-end's operands at C=1 and C=512: one mode-0 block of
    random bytes a channel and a u8-normalized state."""
    from sdr_tpu_torch.models import receiver as rx

    mc = rx.cfg.get_mode_config(0)
    h = rx.design_coeffs(mc, device="cuda").rf
    for c in (1, 512):
        iq = torch.from_numpy(rng.integers(
            0, 256, size=(c, mc.default_block_size(True)),
            dtype=np.uint8)).cuda()
        st = torch.tensor(rng.integers(-128, 128, size=(c, 2, 150)) / 128.0,
                          dtype=torch.float32, device="cuda")
        yield c, iq, h, st, mc.rf_decim


def time_k1(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.ops import fir_frontend

    for c, iq, h, st, d in u8_cases(rng):
        call = lambda: fir_frontend.fir_frontend_u8(iq, h, st, d)
        ms = cuda_ms(call, 20)
        dev = profiled(call, 10, "fir_")
        x2 = (iq.reshape(c, -1, 2).movedim(-1, -2).float() - 128.0) / 128.0
        inp = torch.cat([st, x2], dim=-1).reshape(2 * c, 1, -1).contiguous()
        w = h.flip(0).reshape(1, 1, -1).contiguous()
        lib = cuda_ms(lambda: torch.nn.functional.conv1d(inp, w, stride=d),
                      20)
        res[f"K1 C={c}"] = {"ms": ms, "kernel_ms": dev["kernel_ms"],
                            "events": dev["events"], "conv1d_ms": lib}
        print(f"[{label}] K1 C={c}: {ms:.4f} ms (kernel alone "
              f"{dev['kernel_ms']:.4f} ms, {dev['events']:.0f} device "
              f"events a call), conv1d {lib:.4f} ms")


def time_k4(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.ops import fir_frontend

    for c, iq, h, st, d in u8_cases(rng):
        call = lambda: fir_frontend.fir_frontend_u8_deinterleaved(iq, h, st,
                                                                  d)
        ms = cuda_ms(call, 20)
        dev = profiled(call, 10, "fir_")
        res[f"K4 C={c}"] = {"ms": ms, "kernel_ms": dev["kernel_ms"]}
        print(f"[{label}] K4 C={c}: {ms:.4f} ms (FIR kernel alone "
              f"{dev['kernel_ms']:.4f} ms)")


def time_block(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.models import receiver as rx

    mc = rx.cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    for c, reps in ((1, 30), (512, 10)):
        r = rx.Receiver(0, stereo=True, with_rds=True,
                        batch_shape=(c,) if c > 1 else (), device="cuda")
        blk = torch.from_numpy(rng.integers(
            0, 256, size=((c,) if c > 1 else ()) + (bs,),
            dtype=np.uint8)).cuda()
        wall = cuda_ms(lambda: r.process(blk), reps, warmup=3)
        prof = profiled(lambda: r.process(blk), 5, "fir_")
        b = {"wall_ms": wall, "busy_ms": prof["busy_ms"],
             "idle_share": 1.0 - prof["busy_ms"] / wall,
             "k1_ms": prof["kernel_ms"], "events": prof["events"]}
        res[f"block C={c}"] = b
        print(f"[{label}] mode-0 block C={c}: wall {wall:.3f} ms, device "
              f"busy {b['busy_ms']:.3f} ms, idle share "
              f"{b['idle_share']:.3f}, {b['events']:.0f} device events, K1 "
              f"{b['k1_ms']:.4f} ms")


def time_k6(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.parallel import halo as khalo

    halo = 230_400
    flush = torch.empty(16 * 2 ** 20, device="cuda")      # 64 MB
    rows_form = hasattr(khalo, "row_blocks_of")
    for c in (1, 4):
        ext = torch.tensor(rng.standard_normal((SHARDS * c, 2 * halo)),
                           dtype=torch.float32, device="cuda")
        if rows_form:
            arg = ext.view(1, SHARDS, c, 2 * halo)
        else:
            arg = [[ext[j * c:(j + 1) * c] for j in range(SHARDS)]]
        call = lambda: khalo.halo_shift_right(arg, halo)
        ms = cuda_ms(call, 50)

        def cold():
            flush.fill_(1.0)
            call()
        prof = profiled(cold, 20, "halo")
        res[f"K6 S=8 C={c} call"] = {"ms": ms,
                                     "kernel_cold_ms": prof["kernel_ms"]}
        print(f"[{label}] K6 S=8 C={c} halo {halo} call: whole call "
              f"{ms:.4f} ms (back to back, L2 warm); kernel "
              f"{prof['kernel_ms']:.4f} ms (L2 flushed)")
        lib = cuda_ms(lambda: ext[c:, :halo].copy_(ext[:-c, -halo:]), 50)
        res[f"K6 S=8 C={c} copy_"] = lib
        print(f"[{label}] K6 S=8 C={c} one copy_: {lib:.4f} ms")


def time_wideband(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.models.channelizer import Channelizer

    mc = rx.cfg.get_mode_config(0)
    ch = Channelizer([(k - 32) * 200e3 for k in range(64)], 2 * 9.6e6, 0,
                     device="cuda")
    r = rx.Receiver(0, stereo=True, with_rds=True, batch_shape=(64,),
                    device="cuda")
    blk = torch.from_numpy(rng.integers(
        0, 256, size=mc.default_block_size(True) * ch.decim,
        dtype=np.uint8)).cuda()
    step = lambda: r.process(ch.process(blk))
    wall = cuda_ms(step, 5, warmup=3)
    # the block's float FIR kernels: K5 in the channelizer and the
    # receiver's front-end (every other FIR is a cuBLAS product)
    prof = profiled(step, 3, "fir_")
    b = {"wall_ms": wall, "busy_ms": prof["busy_ms"],
         "idle_share": 1.0 - prof["busy_ms"] / wall,
         "k5_ms": prof["kernel_ms"], "events": prof["events"]}
    res["wideband C=64"] = b
    print(f"[{label}] wideband block C=64 at 19.2 MS/s: wall "
          f"{wall:.3f} ms, device busy {b['busy_ms']:.3f} ms, idle share "
          f"{b['idle_share']:.3f}, K5 {b['k5_ms']:.4f} ms, "
          f"{b['events']:.0f} device events")


def time_sharded(label: str, rng, res: dict) -> None:
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.parallel import (Mesh, default_block_if,
                                        time_sharded_receive)
    from sdr_tpu_torch.utils import synth

    mc = rx.cfg.get_mode_config(0)
    block = default_block_if(mc, True) * 2 * mc.rf_decim   # 115,200 floats
    r = rx.Receiver(0, stereo=True, with_rds=True, batch_shape=(SHARDS,),
                    device="cuda")
    x = torch.tensor(rng.uniform(-1, 1, (SHARDS, block)), dtype=torch.float32,
                     device="cuda")
    wall = cuda_ms(lambda: r.process(x), 20, warmup=3)
    prof = profiled(lambda: r.process(x), 5, "pll_kernel")
    b = {"wall_ms": wall, "busy_ms": prof["busy_ms"],
         "idle_share": 1.0 - prof["busy_ms"] / wall,
         "pll_ms": prof["kernel_ms"], "events": prof["events"]}
    res["time-sharded step S=8"] = b
    print(f"[{label}] time-sharded step S=8 (8 rows x {block} float "
          f"samples): wall {wall:.3f} ms, device busy {b['busy_ms']:.3f} "
          f"ms, idle share {b['idle_share']:.3f}, K2 {b['pll_ms']:.4f} ms")
    res_fm = synth.synthesize_fm(duration_s=4.0, mode=0, seed=SEED,
                                 with_rds=True)
    iq = synth.u8_to_float(res_fm.iq_u8)[: SHARDS * 20 * block]
    mesh = Mesh(["cuda:0"] * SHARDS, ("time",))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = time_sharded_receive(iq, mesh, 0, stereo=True, with_rds=True)
        out.left.cpu()
        walls.append(time.perf_counter() - t0)
    res["time_sharded_receive 4 s S=8 s"] = walls
    print(f"[{label}] time_sharded_receive 4 s capture S=8: "
          + ", ".join(f"{w:.3f}" for w in walls) + " s (host clock)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--parts", default="k1,k4,k5,k6,block,wideband,sharded",
                    help="comma-separated: k1, k4, k5, k6, block, wideband, "
                         "sharded")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from sdr_tpu_torch.models import receiver as rx

    rx.pin_fp32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[{args.label}] card: {smi} | torch {torch.__version__}")
    rng = np.random.default_rng(SEED)
    res = {"label": args.label, "card": smi}
    parts = {"k1": time_k1, "k4": time_k4, "k5": time_k5, "k6": time_k6,
             "block": time_block, "wideband": time_wideband,
             "sharded": time_sharded}
    for name in args.parts.split(","):
        parts[name](args.label, rng, res)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
