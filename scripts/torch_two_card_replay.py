#!/usr/bin/env python3
"""Replay one recording time-sharded across two cards, against one card.

A synthesized mode-0 stereo+RDS capture (4 s by default), normalized and
trimmed to 8 segments of whole blocks, runs through
``time_sharded_receive`` twice: 8 shards on cuda:0, and 4 shards on each
of cuda:0 and cuda:1, where shard 4 reads shard 3's tail over peer access
through K6's table entry.  The two-card run must match the one-card run
(1e-5 on fm_demod and mono, 5e-3 on the PLL-driven left, right and RDS
symbols, the tolerances of ``tests/test_torch_cuda.py``); then each is
timed by host clock over ``--runs`` runs, each ending in a host copy of
the left channel.

    python3 scripts/torch_two_card_replay.py

The card's name and power limit come first.  Needs two NVIDIA GPUs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.parallel import Mesh, default_block_if, time_sharded_receive
from sdr_tpu_torch.parallel import halo as khalo
from sdr_tpu_torch.utils import synth

SEED = 20261016
SHARDS = 8
TOLS = {"fm_demod": 1e-5, "mono": 1e-5, "left": 5e-3, "right": 5e-3,
        "rds_symbols": 5e-3}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if torch.cuda.device_count() < 2:
        raise SystemExit(f"needs two CUDA devices, found "
                         f"{torch.cuda.device_count()}")
    rx.pin_fp32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"cards: {' | '.join(smi.splitlines())} | torch "
          f"{torch.__version__}")
    mc = rx.cfg.get_mode_config(0)
    block = default_block_if(mc, True) * 2 * mc.rf_decim
    res = synth.synthesize_fm(duration_s=args.seconds, mode=0, seed=SEED,
                              with_rds=True)
    iq = synth.u8_to_float(res.iq_u8)
    iq = iq[: len(iq) // (SHARDS * block) * SHARDS * block]
    meshes = {"one card": Mesh(["cuda:0"] * SHARDS, ("time",)),
              "two cards": Mesh(["cuda:0"] * (SHARDS // 2)
                                + ["cuda:1"] * (SHARDS // 2), ("time",))}
    outs, walls = {}, {}
    for name, mesh in meshes.items():
        before = khalo.halo_shift_right.launches
        outs[name] = time_sharded_receive(iq, mesh, 0, stereo=True,
                                          with_rds=True)
        launches = khalo.halo_shift_right.launches - before
        walls[name] = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            out = time_sharded_receive(iq, mesh, 0, stereo=True,
                                       with_rds=True)
            out.left.cpu()
            walls[name].append(time.perf_counter() - t0)
        print(f"{name}: {len(iq) / 2 / mc.rf_fs:.2f} s capture, {SHARDS} "
              f"shards, K6 launches {launches}; host clock "
              + ", ".join(f"{w:.3f}" for w in walls[name]) + " s")
    errs = {f: float((getattr(outs["two cards"], f).cpu()
                      - getattr(outs["one card"], f).cpu()).abs().max())
            for f in TOLS}
    ok = all(errs[f] <= TOLS[f] for f in TOLS)
    print("two cards vs one card: "
          + ", ".join(f"{f} {errs[f]:.3g} (atol {TOLS[f]})" for f in TOLS)
          + ("" if ok else "  FAILED"))
    print(json.dumps({"cards": smi, "walls_s": walls, "max_abs": errs,
                      "ok": ok}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
