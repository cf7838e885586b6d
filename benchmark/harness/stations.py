"""Seeded FM stations and the host-resident ring of raw u8 I/Q the cells
stream.

A frozen copy of ``sdr_tpu_torch/utils/synth.py`` at commit 31744bf
(``synthesize_fm`` and the RDS encoder it calls), with the arithmetic
translated from numpy to PyTorch float64 so that a station of seconds is
made on the card in milliseconds; the mode's rates come from the
configuration file, not from the port.  It imports nothing of the port,
and the program under test never changes it.

Departures from the original, each so that a ring of one period repeats
without a seam (an FM phase jump where it wraps would be a click that no
real stream has): tones rounded to whole cycles of the ring, the RDS
shaping circular, the multiplex's mean removed.

A station is the composite multiplex (mono, 19 kHz pilot, 38 kHz DSB-SC
stereo, 57 kHz BPSK RDS), FM-modulated at the RF rate, with white noise,
quantized to interleaved u8 as an RTL-SDR writes it.  The ring gives each
channel one of a few stations, rotated by a seeded circular offset of its
own, so that no two rows are equal; it wraps at its end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RDS_SYMBOL_RATE = 2375.0
PILOT_FREQ_HZ = 19_000.0

# 26x10 parity-check matrix of the RDS block code and the offset-word
# syndromes (sdr_tpu_torch/golden/rds.py at 31744bf; RDS-spec data)
PARITY_MATRIX = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 1, 0, 1, 1],
], dtype=np.int64)
SYNDROMES = {
    "A": np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 0], dtype=np.int64),
    "B": np.array([1, 1, 1, 1, 0, 1, 0, 1, 0, 0], dtype=np.int64),
    "C": np.array([1, 0, 0, 1, 0, 1, 1, 1, 0, 0], dtype=np.int64),
    "D": np.array([1, 0, 0, 1, 0, 1, 1, 0, 0, 0], dtype=np.int64),
}
OFFSET_SEQUENCE = ("A", "B", "C", "D")


def _gf2_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2) by Gaussian elimination."""
    n = mat.shape[0]
    a = mat.astype(np.int64) % 2
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] = (a[r] + a[col]) % 2
                inv[r] = (inv[r] + inv[col]) % 2
    return inv


def rds_encode_groups(rng: np.random.Generator, n_groups: int) -> np.ndarray:
    """Random RDS groups (offsets A, B, C, D), each 26-bit block's check
    bits solved from the parity equations; the framed bit stream."""
    a, b_inv = PARITY_MATRIX[:16], _gf2_inv(PARITY_MATRIX[16:])
    info = rng.integers(0, 2, size=(n_groups, 4, 16), dtype=np.int64)
    blocks = []
    for g in range(n_groups):
        for b, off in enumerate(OFFSET_SEQUENCE):
            check = ((SYNDROMES[off] - info[g, b] @ a) % 2) @ b_inv % 2
            blocks.append(np.concatenate([info[g, b], check]))
    return np.concatenate(blocks)


def rrc_taps(fs: float, n_taps: int, beta: float = 0.90,
             symbol_rate: float = RDS_SYMBOL_RATE) -> np.ndarray:
    """Root-raised-cosine pulse (``golden/filters.py::rrc_taps``)."""
    t_sym = 1.0 / symbol_rate
    k = np.arange(n_taps, dtype=np.float64)
    t = (k - n_taps / 2.0) / fs
    num = (np.sin(np.pi * t * (1 - beta) / t_sym)
           + 4 * beta * (t / t_sym) * np.cos(np.pi * t * (1 + beta) / t_sym))
    den = np.pi * t * (1 - (4 * beta * t / t_sym) ** 2) / t_sym
    with np.errstate(invalid="ignore", divide="ignore"):
        h = num / den
    h = np.where(t == 0.0, 1.0 + beta * (4 / np.pi - 1.0), h)
    t_sing = t_sym / (4 * beta)
    edge = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    return np.where((t == t_sing) | (t == -t_sing), edge, h)


def _circular_same(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """``fftconvolve(x, h, mode="same")`` with ``x`` read as one period of a
    periodic signal (a circular convolution), so that the result wraps
    without a seam."""
    n, m = x.numel(), len(h)
    hp = torch.zeros(n, dtype=torch.float64, device=x.device)
    hp[:m] = torch.as_tensor(h, device=x.device)
    hp = torch.roll(hp, -((m - 1) // 2))
    return torch.fft.irfft(torch.fft.rfft(x) * torch.fft.rfft(hp), n)


def _shaped_rds(n: int, fs: float, rng: np.random.Generator,
                device) -> torch.Tensor:
    """RRC-shaped bipolar Manchester symbols at ``fs``, one period of n
    samples, peak 1: the symbols that fall in the period, shaped
    circularly."""
    n_sym = int(round(n / fs * RDS_SYMBOL_RATE))
    n_groups = n_sym // 2 // 104 + 1
    bits = np.bitwise_xor.accumulate(rds_encode_groups(rng, n_groups))
    b = bits.astype(np.float64) * 2.0 - 1.0
    symbols = np.stack([b, -b], axis=1).reshape(-1)[:n_sym]
    idx = np.round(np.arange(n_sym) * fs / RDS_SYMBOL_RATE).astype(np.int64)
    train = torch.zeros(n, dtype=torch.float64, device=device)
    train[torch.as_tensor(idx % n, device=device)] = torch.as_tensor(
        symbols, device=device)
    sps_tx = int(round(fs / RDS_SYMBOL_RATE))
    shaped = _circular_same(train, rrc_taps(RDS_SYMBOL_RATE * sps_tx,
                                            8 * sps_tx + 1))
    return shaped / shaped.abs().max()


def synthesize(n: int, rf_fs: float, seed: int, tone_l: float,
               tone_r: float, noise_std: float, with_rds: bool,
               device, deviation_hz: float = 75e3) -> np.ndarray:
    """One station: ``n`` complex samples at ``rf_fs`` as 2n interleaved
    u8 (``synthesize_fm`` with stereo on), made to repeat without a seam
    where the ring wraps: each tone rounded to whole cycles of the n
    samples (as the pilot and its harmonics are at the configurations'
    ring lengths), the RDS symbols shaped circularly, and the
    multiplex's mean over the period taken out, so that the FM phase
    returns to its start.  The noise is white, so it has no seam."""
    rng = np.random.default_rng(seed)
    duration_s = n / rf_fs
    tone_l, tone_r = (round(f * duration_s) / duration_s
                      for f in (tone_l, tone_r))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 63)))
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / rf_fs
    left = 0.9 * torch.sin(2 * math.pi * tone_l * t)
    right = 0.9 * torch.sin(2 * math.pi * tone_r * t)
    pilot_phase = 2 * math.pi * PILOT_FREQ_HZ * t
    mpx = 0.45 * (left + right) / 2.0
    mpx += 0.10 * torch.sin(pilot_phase)
    mpx -= 0.45 * ((left - right) / 2.0) * torch.cos(2.0 * pilot_phase)
    if with_rds:
        shaped = _shaped_rds(n, rf_fs, rng, device)
        mpx += 0.06 * shaped * torch.sin(3.0 * pilot_phase)
    mpx -= mpx.mean()
    # the running sum on the host, in numpy's order, so that a seed gives
    # the same bytes on every device
    phase = torch.as_tensor(
        np.cumsum(mpx.cpu().numpy()) * (2 * math.pi * deviation_hz / rf_fs),
        device=device)
    iq = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1)
    if noise_std > 0:
        iq += noise_std * torch.randn(iq.shape, generator=gen, **f64)
    u8 = torch.clamp(torch.round(iq * 127.0 + 128.0), 0, 255).to(torch.uint8)
    return u8.reshape(-1).cpu().numpy()


def make_ring(cfg: dict, mix: dict, seed: int, device) -> np.ndarray:
    """The cell's host-resident input, (channels, ring_blocks x
    block_bytes) u8, from ``seed``: ``mix["stations"]`` stations with
    seeded tones, each row one of them (row r takes station r mod S)
    rotated by a seeded even offset, distinct within a station."""
    rng = np.random.default_rng([seed, 0x52494E47])
    channels, stations = mix["channels"], min(mix["stations"],
                                              mix["channels"])
    length = mix["ring_blocks"] * cfg["block_bytes"]
    lo, hi = mix["tone_hz"]
    tones = rng.uniform(lo, hi, size=(stations, 2))
    seeds = rng.integers(0, 2 ** 63, size=stations)
    waves = [synthesize(length // 2, cfg["rf_fs"], int(seeds[s]),
                        float(tones[s, 0]), float(tones[s, 1]),
                        mix["noise_std"], cfg["rds"], device)
             for s in range(stations)]
    ring = np.empty((channels, length), dtype=np.uint8)
    per_station = -(-channels // stations)
    offsets = [2 * rng.choice(length // 2, size=per_station, replace=False)
               for _ in range(stations)]
    for r in range(channels):
        s, o = r % stations, int(offsets[r % stations][r // stations])
        ring[r, : length - o] = waves[s][o:]
        ring[r, length - o:] = waves[s][:o]
    return ring
