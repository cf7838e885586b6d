"""Synthetic FM-stereo-RDS IQ generation with known ground truth.

The reference team's #1 proposed improvement was "generating a synthetic RDS
file with known RDS data" (doc/3DY4 Report.pdf, "Proposal for Improvement") —
they could only validate RDS against off-air captures.  This module closes
that gap: it synthesizes a fully coherent FM multiplex —

    mono (L+R)/2  +  19 kHz pilot  +  38 kHz DSB-SC (L-R)/2  +
    57 kHz BPSK RDS (differentially-encoded, Manchester-coded, RRC-shaped,
    offset-word framed)

— FM-modulates it, and emits interleaved u8 I/Q exactly like an RTL-SDR
capture (src/iofunc.cpp:128-135 input format).  Every stage of the receiver
(mono, stereo separation, RDS bits, frame sync) can therefore be verified
against known ground truth.

The RDS encoder derives the 10 check bits per block by *solving* the decoder's
own parity equations over GF(2) (window @ PARITY_MATRIX == offset syndrome),
so encoder and decoder are consistent by construction.

The port's own copy of ``sdr_tpu/utils/synth.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.golden import rds as grds


# ---------------------------------------------------------------------------
# RDS bit-level encoding
# ---------------------------------------------------------------------------

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
    assert (a == np.eye(n, dtype=np.int64)).all()
    return inv


@functools.lru_cache(maxsize=1)
def _check_solver() -> tuple[np.ndarray, np.ndarray]:
    """(A, B_inv): syndrome = info(16) @ A + check(10) @ B  (mod 2)."""
    h = grds.PARITY_MATRIX
    a = h[:16]
    b_inv = _gf2_inv(h[16:])
    return a, b_inv


def rds_encode_block(info16: np.ndarray, offset: str) -> np.ndarray:
    """One 26-bit RDS block whose syndrome equals the given offset's
    (info bits first, check bits last — the order frame_sync scans)."""
    a, b_inv = _check_solver()
    info16 = np.asarray(info16, dtype=np.int64) % 2
    s = grds.SYNDROMES[offset]
    check = ((s - info16 @ a) % 2) @ b_inv % 2
    block = np.concatenate([info16, check])
    assert (grds.gf2_syndrome(block) == s).all()
    return block


def rds_encode_groups(rng: np.ndarray | np.random.Generator,
                      n_groups: int) -> tuple[np.ndarray, np.ndarray]:
    """Random RDS groups -> (info_bits (n_groups,4,16), framed_bits).

    Each group is four blocks with offsets A, B, C, D.
    """
    rng = np.random.default_rng(rng) if not isinstance(
        rng, np.random.Generator) else rng
    info = rng.integers(0, 2, size=(n_groups, 4, 16), dtype=np.int64)
    blocks = [
        rds_encode_block(info[g, b], grds.OFFSET_SEQUENCE[b])
        for g in range(n_groups) for b in range(4)
    ]
    return info, np.concatenate(blocks)


@dataclasses.dataclass(frozen=True)
class StationConfig:
    """Programme information for a structured RDS transmission
    (decoded back by models.rds_groups.decode_station)."""

    pi: int = 0x3D44
    pty: int = 10                 # "Pop Music"
    ps: str = "SDR TPU "          # 8-char Programme Service name
    radiotext: str = "TPU-NATIVE FM RECEIVER"
    tp: bool = False


def _int_to_bits(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.int64)


def rds_encode_station(station: StationConfig, n_groups: int,
                       version_b: bool = False
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Structured RDS groups -> (info_bits (n_groups,4,16), framed_bits).

    Schedules the standard acquisition mix: each cycle sends the four 0A
    groups (PS name segments) followed by the 2A groups covering the
    RadioText (terminated with 0x0D), repeating until ``n_groups``.  The
    inverse of models.rds_groups.decode_station.

    ``version_b=True`` appends the IEC 62106 VERSION-B encodings to each
    cycle (0B/2B: version bit set in block B, the PI code repeated in
    block 3 under offset C', RadioText 2 chars/group) so the decoder's
    B-group path is exercised against ground truth.
    """
    ps = station.ps.ljust(8)[:8]
    rt = station.radiotext[:63] + "\r"
    rt = rt + " " * (-len(rt) % 4)
    n_rt = len(rt) // 4

    def b_word(gtype: int, low5: int, vb: bool = False) -> int:
        return ((gtype << 12) | (int(vb) << 11) | (int(station.tp) << 10)
                | ((station.pty & 0x1F) << 5) | (low5 & 0x1F))

    # (A, B, C, D) words + version flag (block-3 offset differs)
    schedule: list[tuple[tuple[int, int, int, int], bool]] = []
    for addr in range(4):
        d = (ord(ps[2 * addr]) << 8) | ord(ps[2 * addr + 1])
        # block C of 0A carries AF codes; 0xCDCD = "filler" twice
        schedule.append(((station.pi, b_word(0, addr), 0xCDCD, d), False))
    for addr in range(n_rt):
        seg = rt[4 * addr: 4 * addr + 4]
        c = (ord(seg[0]) << 8) | ord(seg[1])
        d = (ord(seg[2]) << 8) | ord(seg[3])
        schedule.append(((station.pi, b_word(2, addr), c, d), False))
    if version_b:
        for addr in range(4):
            d = (ord(ps[2 * addr]) << 8) | ord(ps[2 * addr + 1])
            schedule.append(((station.pi, b_word(0, addr, True),
                              station.pi, d), True))
        rt2 = station.radiotext[:31] + "\r"
        rt2 = rt2 + " " * (-len(rt2) % 2)
        for addr in range(len(rt2) // 2):
            d = (ord(rt2[2 * addr]) << 8) | ord(rt2[2 * addr + 1])
            schedule.append(((station.pi, b_word(2, addr, True),
                              station.pi, d), True))

    words = [schedule[g % len(schedule)] for g in range(n_groups)]
    info = np.stack([
        np.stack([_int_to_bits(w, 16) for w in ws]) for ws, _ in words])
    offs = lambda vb: ("A", "B", "C_apos" if vb else "C", "D")
    blocks = [rds_encode_block(info[g, b], offs(words[g][1])[b])
              for g in range(n_groups) for b in range(4)]
    return info, np.concatenate(blocks)


def diff_encode(bits: np.ndarray) -> np.ndarray:
    """Inverse of golden diff_decode (out[i] = in[i] ^ in[i-1], out[0]=in[0])."""
    return np.bitwise_xor.accumulate(np.asarray(bits, dtype=np.int64))


def manchester_encode(bits: np.ndarray) -> np.ndarray:
    """bit 1 -> (+1, -1), bit 0 -> (-1, +1) — inverse of manchester_decode."""
    b = np.asarray(bits, dtype=np.float64) * 2.0 - 1.0
    return np.stack([b, -b], axis=1).reshape(-1)


# ---------------------------------------------------------------------------
# Multiplex + FM modulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SynthResult:
    iq_u8: np.ndarray          # interleaved u8 I/Q at rf_fs
    left: np.ndarray           # ground-truth L audio at rf_fs
    right: np.ndarray          # ground-truth R audio at rf_fs
    rds_info_bits: np.ndarray  # (n_groups, 4, 16) or empty
    rds_frame_bits: np.ndarray # framed pre-diff-encode bit stream
    mpx: np.ndarray            # composite multiplex at rf_fs


def _shaped_rds_baseband(n: int, rf_fs: float, rng: np.random.Generator,
                         n_groups: int, clock_ppm: float = 0.0,
                         station: "StationConfig | None" = None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RRC-shaped bipolar Manchester symbol stream at rf_fs, length n.

    ``clock_ppm`` offsets the transmit symbol clock (parts-per-million) to
    model real hardware oscillators drifting against the receiver's grid.
    ``station`` switches from random info words to the structured
    programme-information groups of ``rds_encode_station``.
    """
    from sdr_tpu_torch.golden.filters import rrc_taps

    if station is not None:
        info, framed = rds_encode_station(station, n_groups)
    else:
        info, framed = rds_encode_groups(rng, n_groups)
    symbols = manchester_encode(diff_encode(framed))
    # Biphase-element rate IS the 2375 sym/s the receiver chain samples at
    # (config.RDS_SYMBOL_RATE; model/fmSupportLib.py:264 T = 1/2375): each
    # 1187.5 bit/s bit becomes two elements at 2375/s.
    sym_rate = cfg.RDS_SYMBOL_RATE * (1.0 + clock_ppm * 1e-6)
    # impulse train at rf_fs
    idx = np.round(np.arange(len(symbols)) * rf_fs / sym_rate).astype(np.int64)
    idx = idx[idx < n]
    train = np.zeros(n)
    train[idx] = symbols[: len(idx)]
    # transmit-side RRC (receiver applies the matched RRC)
    sps_tx = int(round(rf_fs / sym_rate))
    h = rrc_taps(fs=sym_rate * sps_tx, n_taps=8 * sps_tx + 1)
    try:
        from scipy.signal import fftconvolve
        shaped = fftconvolve(train, h, mode="same")
    except ImportError:  # pragma: no cover
        shaped = np.convolve(train, h, mode="same")
    peak = np.max(np.abs(shaped)) or 1.0
    return shaped / peak, info, framed


def _build_multiplex(duration_s: float, fs: float, mc: cfg.ModeConfig,
                     rng: np.random.Generator, tone_l: float, tone_r: float,
                     with_stereo: bool, with_rds: bool,
                     rds_clock_ppm: float,
                     rds_station: StationConfig | None = None,
                     clock_ppm: float = 0.0):
    """Composite FM multiplex + ground truth at an arbitrary sample rate
    (shared by the single-station and wideband synthesizers).

    ``clock_ppm`` offsets the transmitter's MASTER oscillator: real
    hardware derives the 19 kHz pilot, the 57 kHz subcarrier (3x pilot),
    and the 1187.5 bit/s symbol clock (pilot/16) from one crystal, so a
    ppm error shifts them all together.  ``rds_clock_ppm`` additionally
    offsets only the symbol clock (a pure symbol-timing stressor)."""
    n = int(round(duration_s * fs))
    t = np.arange(n) / fs
    scale = 1.0 + clock_ppm * 1e-6

    left = 0.9 * np.sin(2 * np.pi * tone_l * t)
    right = 0.9 * np.sin(2 * np.pi * tone_r * t)

    mpx = 0.45 * (left + right) / 2.0
    rds_info = np.zeros((0, 4, 16), dtype=np.int64)
    rds_framed = np.zeros(0, dtype=np.int64)
    if with_stereo:
        pilot_phase = 2 * np.pi * cfg.PILOT_FREQ_HZ * scale * t
        mpx = mpx + 0.10 * np.sin(pilot_phase)
        # DSB-SC at 38 kHz, phase-locked to the pilot (2x).  The receiver's
        # PLL (atan2 detector, model/fmSupportLib.py:297-353) locks its
        # doubled NCO onto -cos(2*pilot_phase) for a sin pilot (verified
        # empirically in tests/test_golden_e2e.py), so that is the subcarrier
        # phase a transmitter for this receiver family must use.
        mpx = mpx - 0.45 * ((left - right) / 2.0) * np.cos(2.0 * pilot_phase)
    if with_rds and mc.rds is not None:
        n_groups = max(2, int(duration_s * cfg.RDS_SYMBOL_RATE / 2 / 104) + 1)
        shaped, rds_info, rds_framed = _shaped_rds_baseband(
            n, fs, rng, n_groups,
            clock_ppm=rds_clock_ppm + clock_ppm,
            station=rds_station)
        pilot_phase = 2 * np.pi * cfg.PILOT_FREQ_HZ * scale * t
        # 57 kHz = 3x pilot, phase-locked
        mpx = mpx + 0.06 * shaped * np.sin(3.0 * pilot_phase)
    return mpx, left, right, rds_info, rds_framed


def synthesize_fm(duration_s: float = 0.5, mode: int | cfg.Mode = 0,
                  seed: int = 0, tone_l: float = 800.0, tone_r: float = 1500.0,
                  with_stereo: bool = True, with_rds: bool = True,
                  deviation_hz: float = 75e3,
                  noise_std: float = 0.0,
                  rds_clock_ppm: float = 0.0,
                  rds_station: StationConfig | None = None,
                  clock_ppm: float = 0.0) -> SynthResult:
    """Synthesize an FM station and return u8 IQ + ground truth.

    ``rds_station`` transmits structured programme information (PI/PTY/
    PS name/RadioText) instead of random groups — the full-chain ground
    truth for models.rds_groups.decode_station.  ``clock_ppm`` models a
    drifting transmit master oscillator (pilot + subcarrier + symbol
    clock together); ``rds_clock_ppm`` drifts the symbol clock alone.
    """
    mc = cfg.get_mode_config(mode)
    rng = np.random.default_rng(seed)
    rf_fs = mc.rf_fs
    n = int(round(duration_s * rf_fs))
    mpx, left, right, rds_info, rds_framed = _build_multiplex(
        duration_s, rf_fs, mc, rng, tone_l, tone_r, with_stereo, with_rds,
        rds_clock_ppm, rds_station=rds_station, clock_ppm=clock_ppm)

    # FM modulate: instantaneous frequency = deviation * mpx
    phase = 2 * np.pi * deviation_hz * np.cumsum(mpx) / rf_fs
    i = np.cos(phase)
    q = np.sin(phase)
    if noise_std > 0:
        i = i + rng.normal(0, noise_std, n)
        q = q + rng.normal(0, noise_std, n)

    iq = np.empty(2 * n, dtype=np.float64)
    iq[0::2] = i
    iq[1::2] = q
    iq_u8 = np.clip(np.round(iq * 127.0 + 128.0), 0, 255).astype(np.uint8)
    return SynthResult(iq_u8, left, right, rds_info, rds_framed, mpx)


@dataclasses.dataclass
class WidebandResult:
    iq_u8: np.ndarray                 # interleaved u8 at fs_wide
    fs_wide: float
    offsets_hz: list[float]
    stations: list[SynthResult]       # per-station ground truth (mpx etc.)


def synthesize_wideband(duration_s: float, fs_wide: float,
                        offsets_hz, mode: int | cfg.Mode = 0,
                        seed: int = 0, with_rds: bool = True,
                        noise_std: float = 0.0) -> WidebandResult:
    """A wideband capture containing several FM stations at carrier offsets.

    Each station is an independent full multiplex (distinct tones and RDS
    groups) FM-modulated at ``fs_wide`` and mixed to its offset; the sum is
    quantized to interleaved u8 like a wideband SDR capture.  Feed through
    models.channelizer to recover the per-station channel batch.
    """
    mc = cfg.get_mode_config(mode)
    rng = np.random.default_rng(seed)
    n = int(round(duration_s * fs_wide))
    t = np.arange(n) / fs_wide
    total = np.zeros(n, dtype=np.complex128)
    stations: list[SynthResult] = []
    for k, f_off in enumerate(offsets_hz):
        srng = np.random.default_rng(seed + 1000 * (k + 1))
        tone_l = 600.0 + 300.0 * k
        tone_r = 2300.0 - 400.0 * k
        mpx, left, right, info, framed = _build_multiplex(
            duration_s, fs_wide, mc, srng, tone_l, tone_r, True, with_rds,
            0.0)
        phase = 2 * np.pi * 75e3 * np.cumsum(mpx) / fs_wide
        z = np.exp(1j * (phase + 2 * np.pi * f_off * t))
        total += z
        stations.append(SynthResult(np.zeros(0, np.uint8), left, right,
                                    info, framed, mpx))
    total /= len(offsets_hz)
    if noise_std > 0:
        total = total + (rng.normal(0, noise_std, n)
                         + 1j * rng.normal(0, noise_std, n))
    iq = np.empty(2 * n, dtype=np.float64)
    iq[0::2] = total.real
    iq[1::2] = total.imag
    iq_u8 = np.clip(np.round(iq * 127.0 + 128.0), 0, 255).astype(np.uint8)
    return WidebandResult(iq_u8, fs_wide, list(offsets_hz), stations)


def u8_to_float(iq_u8: np.ndarray) -> np.ndarray:
    """Normalize u8 IQ to [-1, 1) float32 — (x - 128) / 128
    (ref: src/iofunc.cpp:128-135, model/stereo.py:86).  Delegates to
    sdr_tpu_torch.io (native fast path when available)."""
    from sdr_tpu_torch.io import u8_normalize
    return u8_normalize(iq_u8)
