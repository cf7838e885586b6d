#!/usr/bin/env python3
"""Time the chunk program (``Program.scan``) per K against the per-block
program, on one card.

Three cells of mode-0 stereo+RDS on random blocks: u8 at C=1 and C=512
(115,200-byte blocks), and the time-sharded step at S=8 (8 rows of one
115,200-sample float block, K2 pinned as the time-sharded path pins it).
For each cell, in one process: the per-block program, then a fresh chunk
program at each K of ``--ks``, then the per-block program again.  Per
block: wall by CUDA events over back-to-back calls, and under
``torch.profiler`` device busy, idle share, device events and host
launches (``chip_smoke.py``'s measures); per chunk program: the warm-up
and capture seconds (host clock around a synchronize), the bytes its pool
reserved and the bytes of its stacked outputs.  Each chunk replay is
checked torch.equal to the per-block program on the same blocks.

    PYTHONPATH=. python3 scripts/torch_chunk_sweep.py [--ks 4,8,16,32,64]

Prints the card's name and power limit first and one JSON line last; with
``--out`` also writes the JSON there.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from chip_smoke import _profiled_block, card, cuda_ms
from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.models import program
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.ops import fir_frontend
from sdr_tpu_torch.parallel import default_block_if

SEED = 20261017


def _cells(rng, k_max: int) -> dict:
    """name -> (k_max blocks (k_max, ..., block) on the card, fused_mixer,
    reps of the per-block program)."""
    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    u8 = lambda lead: torch.from_numpy(rng.integers(
        0, 256, (k_max,) + lead + (bs,), dtype=np.uint8)).cuda()
    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    rows = fir_frontend.normalize_u8(torch.from_numpy(rng.integers(
        0, 256, (k_max, 8, block_raw), dtype=np.uint8)).cuda())
    return {"C=1": (u8(()), None, 50), "C=512": (u8((512,)), None, 20),
            "time-sharded step S=8": (rows, rx.fused_mixer_policy(1, 2), 30)}


def _turn(fn, reps: int, blocks: int) -> dict:
    wall = cuda_ms(fn, reps, warmup=2) / blocks
    prof = _profiled_block(fn, 3)
    prof = {k: v / blocks for k, v in prof.items()}
    return dict(wall_ms=wall, idle_share=1.0 - prof["busy_ms"] / wall, **prof)


def sweep(ks: list[int], rng) -> dict:
    mc = cfg.get_mode_config(0)
    res = {}
    for name, (xs, fused, reps) in _cells(rng, max(ks)).items():
        lead = tuple(xs.shape[1:-1])
        coeffs = rx.design_coeffs(mc, device="cuda")
        one = rx.make_block_fn(mc, True, True, fused_mixer=fused)
        st = [rx.init_state(mc, lead, device="cuda")]

        def per_block():
            st[0] = one(xs[0], coeffs, st[0])[1]
        turns = [dict(kind="program", blocks=1, **_turn(per_block, reps, 1))]
        for k in ks:
            # the reference: k chained blocks through the per-block program
            s, outs = rx.init_state(mc, lead, device="cuda"), []
            for b in range(k):
                out, s = one(xs[b], coeffs, s)
                outs.append(out)
            want = program.tree_leaves(rx.map_state(
                lambda *a: torch.stack(a), *outs)) + program.tree_leaves(s)
            fn = rx.make_block_fn(mc, True, True, fused_mixer=fused)
            got, s = fn.scan(xs[:k], coeffs, rx.init_state(mc, lead,
                                                           device="cuda"))
            got = program.tree_leaves(got) + program.tree_leaves(s)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} K={k}: the chunk graph departs "
                                     "from the per-block program")
            del outs, want, got
            sc = [s]

            def chunk():
                sc[0] = fn.scan(xs[:k], coeffs, sc[0])[1]
            (cap,) = fn.captures
            out_bytes = sum(t.numel() * t.element_size() for t in
                            program.tree_leaves(fn._entries[
                                next(iter(fn._entries))].out))
            turns.append(dict(
                kind="chunk", blocks=k, **_turn(chunk, max(2, reps // k), k),
                warm_up_s=cap.warm_up_s, capture_s=cap.capture_s,
                pool_bytes=cap.pool_bytes, out_bytes=out_bytes))
            del fn, chunk
            torch.cuda.empty_cache()
        turns.append(dict(kind="program", blocks=1,
                          **_turn(per_block, reps, 1)))
        res[name] = turns
        for t in turns:
            extra = (f", capture {t['warm_up_s']:.3f} + {t['capture_s']:.3f}"
                     f" s, pool {t['pool_bytes'] / 2 ** 20:.1f} MiB "
                     f"(stacked outputs {t['out_bytes'] / 2 ** 20:.1f} MiB)"
                     if t["kind"] == "chunk" else "")
            print(f"{name} {t['kind']} K={t['blocks']}: wall "
                  f"{t['wall_ms']:.4f} ms/block, busy {t['busy_ms']:.4f}, "
                  f"idle {t['idle_share']:.3f}, {t['events']:.1f} device "
                  f"events, {t['host_launches']:.2f} host launches per block"
                  + extra, flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ks", default="4,8,16,32,64")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    rx.pin_fp32_matmul()
    smi = card()
    print(f"card: {smi}; torch {torch.__version__}")
    res = {"card": smi, "torch": torch.__version__,
           "cells": sweep([int(k) for k in a.ks.split(",")],
                          np.random.default_rng(SEED))}
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
