#!/usr/bin/env python3
"""Time-shard error against overlap length, through the PyTorch port on
the card.

The port's counterpart of ``scripts/overlap_convergence.py``: the same
2.4 s mode-0 stereo stations (seed 21, noise 0, 0.02 and 0.1), trimmed to
8 segments of whole 5,000-IF-sample blocks, time-sharded over S=8 shards
on one device (``Mesh([device] * 8)``: the shards as rows of one batch,
K6 for the halos, the chunk programs) at overlaps of 1-12 blocks, each
against a contiguous run of the whole capture as one block on the same
device.  Per overlap: the kept-region relative RMS error of L per shard
(the JAX script's metric), and the gates ``chip_smoke.py``'s
``_sharded_gates`` applies (fm_demod and mono max abs error, shard 0's
left max abs error, the left channel's RMS error after 8,000 samples
relative to the reference RMS).  Writes
``docs/torch_overlap_convergence.json`` (on the CPU: ``build/studies/``),
gated by ``tests/test_torch_overlap_convergence.py``.

    python3 scripts/torch_overlap_convergence.py [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch_studies

import numpy as np  # noqa: E402

from sdr_tpu_torch import config as cfg  # noqa: E402
from sdr_tpu_torch.models.receiver import Receiver  # noqa: E402
from sdr_tpu_torch.parallel import Mesh, time_sharded_receive  # noqa: E402
from sdr_tpu_torch.parallel import time_shard  # noqa: E402
from sdr_tpu_torch.utils import synth  # noqa: E402

SHARDS = 8
OVERLAP_BLOCKS = (1, 2, 3, 4, 6, 8, 12)
NOISES = (0.0, 0.02, 0.1)
RELOCK_SKIP = 8000      # audio samples, as chip_smoke.py's gate


def main(argv=None) -> int:
    a = torch_studies.parser(__doc__).parse_args(argv)
    record = torch_studies.device_record(a.device)
    print(f"device: {record}", flush=True)
    mc = cfg.get_mode_config(0)
    block_if = time_shard.default_block_if(mc, False)
    gran = block_if * 2 * mc.rf_decim
    mesh = Mesh([a.device] * SHARDS, ("time",))
    default_blocks = time_shard.halo_raw(mc, block_if) // gran
    t0 = time.perf_counter()
    rows = []
    for noise_std in NOISES:
        res = synth.synthesize_fm(duration_s=2.4, mode=0, with_stereo=True,
                                  with_rds=False, seed=21,
                                  noise_std=noise_std)
        iq = synth.u8_to_float(res.iq_u8)
        seg = (iq.shape[-1] // SHARDS) // gran * gran
        iq = iq[: seg * SHARDS]
        ref = Receiver(0, stereo=True, device=a.device).run(
            iq, block_size=iq.shape[-1])
        host = lambda t: t.cpu().numpy().reshape(-1)
        left_ref, fm_ref, mono_ref = (host(ref.left), host(ref.fm_demod),
                                      host(ref.mono))
        ref_rms = float(np.sqrt(np.mean(left_ref ** 2)))
        for n_blocks in OVERLAP_BLOCKS:
            overlap_if = n_blocks * block_if
            outs = time_sharded_receive(iq, mesh, 0, stereo=True,
                                        with_rds=False, overlap_if=overlap_if)
            left = host(outs.left)
            per_shard = (left - left_ref).reshape(SHARDS, -1)
            # shard 0 is exact (fresh-state reset); the PLL re-lock error
            # lives in shards 1..S-1
            rel = [float(np.sqrt(np.mean(e ** 2)) / ref_rms)
                   for e in per_shard]
            d = left[RELOCK_SKIP:] - left_ref[RELOCK_SKIP:]
            rows.append({
                "noise_std": noise_std,
                "overlap_blocks": n_blocks,
                "overlap_if_samples": overlap_if,
                "overlap_ms": overlap_if / mc.if_fs * 1e3,
                "shard0_rel_rms": rel[0],
                "worst_other_shard_rel_rms": max(rel[1:]),
                "mean_other_shard_rel_rms": float(np.mean(rel[1:])),
                "fm_demod_max_abs_err": float(np.abs(
                    host(outs.fm_demod) - fm_ref).max()),
                "mono_max_abs_err": float(np.abs(host(outs.mono)
                                                 - mono_ref).max()),
                "shard0_left_max_abs_err": float(np.abs(
                    per_shard[0]).max()),
                "relock_rel_rms": float(np.sqrt(np.mean(d ** 2))
                                        / np.sqrt(np.mean(
                                            left_ref[RELOCK_SKIP:] ** 2))),
            })
            r = rows[-1]
            print(f"noise={noise_std:4.2f} overlap={n_blocks:2d} blk "
                  f"({overlap_if:6d} IF, {r['overlap_ms']:6.1f} ms): worst "
                  f"shard rel-RMS {r['worst_other_shard_rel_rms']:.2e}, "
                  f"shard0 {rel[0]:.2e}, fm/mono max err "
                  f"{r['fm_demod_max_abs_err']:.2e}/"
                  f"{r['mono_max_abs_err']:.2e}, relock rel RMS "
                  f"{r['relock_rel_rms']:.2e}", flush=True)
    torch_studies.write("torch_overlap_convergence.json", a.device, a.out, {
        **record, "script": "scripts/torch_overlap_convergence.py",
        "seconds": time.perf_counter() - t0, "mode": 0, "shards": SHARDS,
        "block_if": block_if, "default_overlap_blocks": default_blocks,
        "relock_skip": RELOCK_SKIP,
        "metric": "per-shard kept-region RMS(left - contiguous)/RMS(left)",
        "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
