#!/usr/bin/env python3
"""Time the port's PLL kernels (K2, K3) and the mode-0 block on one card.

For comparing two versions of ``sdr_tpu_torch`` in one call, in turns: the
package is taken from ``PYTHONPATH``, so the same script times any tree
that has the same public functions (``pll_cuda.LaneLayout``,
``pll_angles``, ``pll_mixer``, ``Receiver``)::

    git archive HEAD | tar -x -C build/parent     # the parent, gitignored
    for t in parent change change parent; do
      PYTHONPATH=$([ $t = parent ] && echo build/parent || echo .) \\
        python3 scripts/torch_pll_ab.py --label $t
    done

Prints one line per measurement and a JSON line with all of them:

* K2 at 2, 16 and 1,024 lanes and K3 at 2 and 1,024 lanes, one
  5,760-step block each (the main path's C=1 and C=512 shapes and the S=8
  time-sharded step's 16 lanes): CUDA events over repeated launches;
* the chain floor (``pll_cuda.chain_floor``), where the tree has one;
* the mode-0 stereo+RDS block on random u8 at C=1 and C=512: wall per
  block (CUDA events over back-to-back blocks), and under
  ``torch.profiler`` the device busy time per block (the union of the
  device intervals of kernel and memcpy events), the device events per
  block, the PLL kernel's time, and the idle share 1 - busy / wall.

The card's name and power limit come first.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

N = 5760
SEED = 20261016


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


def pll_case(rng, c: int, mixer: bool):
    """One block of PLL inputs at c channels x (pilot, RDS) arms, laid out
    by the tree's own LaneLayout."""
    from sdr_tpu_torch import stimulus
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.ops import pll as tpll
    from sdr_tpu_torch.ops import pll_cuda

    mc = rx.cfg.get_mode_config(0)
    x = torch.from_numpy(stimulus.pll_tones(rng, c, N, mc.if_fs)).cuda()
    mix = torch.tensor(rng.standard_normal((c, 2, N)), dtype=torch.float32,
                       device="cuda")
    st0 = rx.init_state(mc, (c,), device="cuda")
    ly = pll_cuda.LaneLayout(x, (rx.pilot_pll_params(mc),
                                 rx.rds_pll_params(mc)))
    c0 = ly.carry0(tpll.stack_arms([st0.pilot_pll, st0.rds_pll]), mixer)
    return ly.time_major(x), ly.time_major(mix), c0, ly.consts(mixer)


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


def block(rng, c: int, reps: int, profiled: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdr_tpu_torch.models import receiver as rx

    mc = rx.cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    r = rx.Receiver(0, stereo=True, with_rds=True,
                    batch_shape=(c,) if c > 1 else (), device="cuda")
    blk = torch.from_numpy(rng.integers(
        0, 256, size=((c,) if c > 1 else ()) + (bs,), dtype=np.uint8)).cuda()
    wall = cuda_ms(lambda: r.process(blk), reps, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            r.process(blk)
        torch.cuda.synchronize()
    # a span's device side (``utils.profiling.span``) is an annotation
    # over the kernels it launched, not work
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in dev])
    pll = busy_ms([(e.time_range.start, e.time_range.end) for e in dev
                   if "pll_kernel" in e.name])
    return {"wall_ms": wall, "busy_ms": busy / profiled,
            "events": len(dev) / profiled, "pll_ms": pll / profiled,
            "idle_share": 1.0 - busy / profiled / wall}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from sdr_tpu_torch.models import receiver as rx
    from sdr_tpu_torch.ops import pll_cuda

    rx.pin_fp32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[{args.label}] card: {smi} | torch {torch.__version__}")
    rng = np.random.default_rng(SEED)
    res = {"label": args.label, "card": smi}
    for kind, c in (("K2", 1), ("K2", 8), ("K2", 512), ("K3", 1),
                    ("K3", 512)):
        xs, ms_, c0, consts = pll_case(rng, c, kind == "K3")
        if kind == "K3":
            fn = lambda: pll_cuda.pll_mixer(xs, ms_, c0, consts)
        else:
            fn = lambda: pll_cuda.pll_angles(xs, c0, consts)
        ms = cuda_ms(fn, 20)
        key = f"{kind} {2 * c} lanes"
        res[key] = ms
        print(f"[{args.label}] {key} x {N}: {ms:.4f} ms "
              f"({ms / N * 1e6:.1f} ns/step)")
    if hasattr(pll_cuda, "chain_floor"):
        xs, _, c0, consts = pll_case(rng, 1, False)
        ms = cuda_ms(lambda: pll_cuda.chain_floor(c0, consts, N), 20)
        res["floor"] = ms
        print(f"[{args.label}] chain floor x {N}: {ms:.4f} ms "
              f"({ms / N * 1e6:.1f} ns/step)")
    for c, reps in ((1, 30), (512, 10)):
        b = block(rng, c, reps, 5)
        res[f"block C={c}"] = b
        print(f"[{args.label}] mode-0 block C={c}: wall {b['wall_ms']:.3f} "
              f"ms, device busy {b['busy_ms']:.3f} ms, idle share "
              f"{b['idle_share']:.3f}, {b['events']:.0f} device events, "
              f"PLL kernel {b['pll_ms']:.4f} ms")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
