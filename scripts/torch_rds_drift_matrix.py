#!/usr/bin/env python3
"""RDS under transmitter clock drift, through the PyTorch port on the card.

The port's counterpart of ``scripts/rds_drift_matrix.py``: the same 9 s
mode-0 stations (seed 7, noise 0.1) with the master clock off by +-50,
+-100, +-200 and 0 ppm, each through ``Receiver.run`` (the chunk
programs) on ``--device`` (default cuda), decoded with the fixed-phase
robust CDR and the windowed tracking CDR (256 symbols), and streamed
block by block through the tracking ``StreamingRdsDecoder`` (the CLI's
``--rds-algo tracking``).  Writes ``docs/torch_rds_drift.json`` (on the
CPU: ``build/studies/``), gated by ``tests/test_torch_rds_drift.py``.

    python3 scripts/torch_rds_drift_matrix.py [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch_studies

from sdr_tpu_torch import config as cfg  # noqa: E402
from sdr_tpu_torch.models import rds_decode  # noqa: E402
from sdr_tpu_torch.models.receiver import Receiver  # noqa: E402
from sdr_tpu_torch.utils import metrics, synth  # noqa: E402

DURATION_S = 9.0
NOISE = 0.1
WINDOW = 256
PPMS = (50.0, -50.0, 100.0, -100.0, 200.0, -200.0, 0.0)


def run_ppm(ppm: float, device) -> dict:
    res = synth.synthesize_fm(duration_s=DURATION_S, mode=0, seed=7,
                              with_rds=True, clock_ppm=ppm, noise_std=NOISE)
    outs = Receiver(0, stereo=True, with_rds=True, device=device).run(
        res.iq_u8)
    symbols = outs.rds_symbols.cpu().numpy()
    sps = cfg.get_mode_config(0).rds.sps
    row = {"clock_ppm": ppm,
           "frames_sent": int(res.rds_info_bits.shape[0]) * 4}
    for label, kw in (("fixed_phase", {}),
                      ("tracking", {"window_symbols": WINDOW})):
        dec = rds_decode.decode_robust(symbols.reshape(-1), sps, **kw)
        h, t = metrics.rds_accuracy(dec.info_words, res.rds_info_bits)
        row[label] = {"frames": len(dec.frames.matches),
                      "word_accuracy": round(h / max(t, 1), 4)}
    dec = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                         window_symbols=WINDOW)
    for blk in symbols:
        dec.feed(blk)
    dec.flush()
    row["streaming_tracking_frames"] = dec.n_matches
    return row


def main(argv=None) -> int:
    a = torch_studies.parser(__doc__).parse_args(argv)
    record = torch_studies.device_record(a.device)
    print(f"device: {record}", flush=True)
    t0 = time.perf_counter()
    rows = [run_ppm(p, a.device) for p in PPMS]
    for r in rows:
        print(f"ppm={r['clock_ppm']:+6.1f}: sent {r['frames_sent']}, fixed "
              f"{r['fixed_phase']['frames']} (acc "
              f"{r['fixed_phase']['word_accuracy']:.3f}) vs tracking "
              f"{r['tracking']['frames']} (acc "
              f"{r['tracking']['word_accuracy']:.3f}); streaming "
              f"{r['streaming_tracking_frames']}", flush=True)
    torch_studies.write("torch_rds_drift.json", a.device, a.out, {
        **record, "script": "scripts/torch_rds_drift_matrix.py",
        "seconds": time.perf_counter() - t0, "duration_s": DURATION_S,
        "noise_std": NOISE, "window_symbols": WINDOW, "mode": 0,
        "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
