#!/usr/bin/env python3
"""SNR robustness matrix of the PyTorch port, on the card.

The port's counterpart of ``scripts/snr_matrix.py``: the same station,
seed, tones, 1.2 s duration and 8 input-noise levels (AWGN std on
unit-scale I/Q before the u8 quantize), each through
``sdr_tpu_torch.models.receiver.Receiver.run`` (the chunk programs) on
``--device`` (default cuda).  Per level: stereo separation (L and R), the
mono tone SNR, and RDS info-word accuracy for the robust CDR, the
reference-faithful CDR and the robust CDR with burst error correction.
Writes ``docs/torch_snr_matrix.json`` (on the CPU: ``build/studies/``),
gated by ``tests/test_torch_snr_matrix.py`` against the JAX package's
``docs/snr_matrix.json``.

    python3 scripts/torch_snr_matrix.py [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch_studies

import numpy as np  # noqa: E402

from sdr_tpu_torch import config as cfg  # noqa: E402
from sdr_tpu_torch.models import rds_decode, rds_groups  # noqa: E402
from sdr_tpu_torch.models.receiver import Receiver  # noqa: E402
from sdr_tpu_torch.utils import metrics, synth  # noqa: E402

LEVELS = (0.0, 0.02, 0.05, 0.1, 0.2, 0.4, 0.5, 0.63)
TONE_L, TONE_R = 800.0, 1500.0
DURATION_S = 1.2


def run_level(noise_std: float, device, seed: int = 3) -> dict:
    mc = cfg.get_mode_config(0)
    station = synth.StationConfig(pi=0x54B1, pty=9, ps="TPU8 FM ",
                                  radiotext="HELLO TPU!", tp=True)
    res = synth.synthesize_fm(duration_s=DURATION_S, mode=0, seed=seed,
                              tone_l=TONE_L, tone_r=TONE_R, with_rds=True,
                              noise_std=noise_std, rds_station=station)
    outs = Receiver(0, stereo=True, with_rds=True, device=device).run(
        res.iq_u8)
    host = lambda t: t.cpu().numpy()
    left, right = host(outs.left).reshape(-1), host(outs.right).reshape(-1)
    mono = host(outs.mono).reshape(-1)
    sep_l, sep_r = metrics.stereo_separation_db(left, right, mc.audio_fs,
                                                TONE_L, TONE_R)
    # mono = (L+R)/2 carries both tones: the R tone's band is kept out of
    # the noise estimate, as the JAX script does
    snr_mono = metrics.tone_snr_db(mono[6000:], mc.audio_fs, TONE_L,
                                   exclude=(TONE_R,))
    syms = host(outs.rds_symbols)
    row = {"noise_std": noise_std,
           "separation_db_l": round(float(sep_l), 1),
           "separation_db_r": round(float(sep_r), 1),
           "mono_tone_snr_db": round(float(snr_mono), 1)}
    decoders = (
        ("robust", lambda s: rds_decode.decode_robust(s.reshape(-1),
                                                      mc.rds.sps)),
        ("reference", lambda s: rds_decode.decode_reference(s, mc.rds.sps)),
        ("robust_ec", lambda s: rds_decode.decode_robust(
            s.reshape(-1), mc.rds.sps, error_correction=True)),
    )
    for algo, fn in decoders:
        dec = fn(syms)
        hits, total = metrics.rds_accuracy(dec.info_words, res.rds_info_bits)
        st = rds_groups.decode_station_from(dec)
        row[f"rds_{algo}"] = {"frames": len(dec.frames.matches),
                              "word_accuracy": round(hits / max(total, 1), 4),
                              "pi_ok": st.pi == 0x54B1,
                              "ps_ok": st.ps_name == "TPU8 FM "}
        if algo == "robust_ec":
            row[f"rds_{algo}"]["corrected"] = dec.n_corrected
    return row


def main(argv=None) -> int:
    a = torch_studies.parser(__doc__).parse_args(argv)
    record = torch_studies.device_record(a.device)
    print(f"device: {record}", flush=True)
    t0 = time.perf_counter()
    rows = [run_level(n, a.device) for n in LEVELS]
    for r in rows:
        print(f"noise={r['noise_std']:4.2f}: sep L/R "
              f"{r['separation_db_l']:5.1f}/{r['separation_db_r']:5.1f} dB,"
              f" mono SNR {r['mono_tone_snr_db']:5.1f} dB, RDS acc robust "
              f"{r['rds_robust']['word_accuracy']:.3f} "
              f"({r['rds_robust']['frames']} fr) / reference "
              f"{r['rds_reference']['word_accuracy']:.3f} "
              f"({r['rds_reference']['frames']} fr) / EC "
              f"{r['rds_robust_ec']['word_accuracy']:.3f} "
              f"({r['rds_robust_ec']['frames']} fr)", flush=True)
    torch_studies.write("torch_snr_matrix.json", a.device, a.out, {
        **record, "script": "scripts/torch_snr_matrix.py",
        "seconds": time.perf_counter() - t0, "mode": 0,
        "duration_s": DURATION_S, "tones_hz": [TONE_L, TONE_R],
        "noise_model": "AWGN std on unit-scale IQ before u8 quantize",
        "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
