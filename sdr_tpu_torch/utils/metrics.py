"""Signal-quality metrics for receiver validation (the port's copy of
``sdr_tpu/utils/metrics.py``, numpy only).

Consolidates the measurements the test-suite and the reference's manual
validation rely on: stereo separation (reference: synthetic L/R raw files,
SURVEY.md §4.4), tone SNR, and RDS decode accuracy against transmitted
ground truth.
"""

from __future__ import annotations

import numpy as np


def tone_power(x: np.ndarray, fs: float, f: float) -> float:
    """Power of the complex demodulated tone at frequency ``f`` (single-bin
    Goertzel-style estimate)."""
    x = np.asarray(x, dtype=np.float64)
    t = np.arange(len(x)) / fs
    return float(np.abs(np.mean(x * np.exp(-2j * np.pi * f * t))) ** 2)


def stereo_separation_db(left: np.ndarray, right: np.ndarray, fs: float,
                         tone_l: float, tone_r: float,
                         skip: int = 6000) -> tuple[float, float]:
    """(L, R) channel separation in dB for a two-tone stereo test signal
    (tone_l transmitted only on L, tone_r only on R); ``skip`` drops the
    PLL lock-in transient."""
    l, r = np.asarray(left)[skip:], np.asarray(right)[skip:]
    sep_l = tone_power(l, fs, tone_l) / max(tone_power(l, fs, tone_r), 1e-30)
    sep_r = tone_power(r, fs, tone_r) / max(tone_power(r, fs, tone_l), 1e-30)
    return 10 * np.log10(sep_l), 10 * np.log10(sep_r)


def tone_snr_db(x: np.ndarray, fs: float, f: float,
                bw: float = 60.0,
                exclude: tuple[float, ...] = ()) -> float:
    """Tone power over total out-of-band power via rfft binning.

    The band is widened to at least +-3 FFT bins so Hann spectral leakage
    of the tone itself never counts as noise on short windows.
    ``exclude`` lists other intentional tone frequencies whose bands count
    as neither signal nor noise — e.g. measuring the 800 Hz L tone's SNR
    in a MONO mix that also carries the 1.5 kHz R tone (without the
    exclusion the other tone dominates "noise" and the metric saturates
    near 0 dB regardless of the actual noise floor).
    """
    x = np.asarray(x, dtype=np.float64)
    bw = max(bw, 3.0 * fs / len(x))
    xf = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f - bw) & (freqs < f + bw)
    sig = xf[band].sum()
    drop = np.zeros_like(band)
    for fe in exclude:
        drop |= (freqs > fe - bw) & (freqs < fe + bw)
    noise = xf[~band & ~drop].sum()
    return 10 * np.log10(sig / max(noise, 1e-30))


def rds_accuracy(info_words: np.ndarray,
                 sent_groups: np.ndarray) -> tuple[int, int]:
    """(correct, total) decoded 16-bit info words vs transmitted groups
    (synth.SynthResult.rds_info_bits layout (n_groups, 4, 16))."""
    sent = {tuple(w) for g in np.asarray(sent_groups) for w in g}
    hits = sum(tuple(w) in sent for w in np.asarray(info_words))
    return hits, len(info_words)
