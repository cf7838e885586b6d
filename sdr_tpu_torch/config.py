"""Typed mode/parameter configuration for the FM receiver.

The reference hard-codes per-mode parameter tables in every entry point
(src/project.cpp:424-427, src/threadMonoOnly.cpp:229-232, model/stereo.py:62-71,
model/fmRDS.py:55-74) and magic constants in include/dy4.h:23-30.  Here they are
centralized as one frozen dataclass so every layer (golden model, JAX ops,
receiver models, benchmarks) reads the same source of truth.

Sample-rate plan (group-28 constraints, doc/3dy4-constraints-group-28.pdf):

====  ========  =======  ========  ========  ==================  ==============
Mode  RF Fs     IF Fs    Audio Fs  rf_decim  audio up/down       RDS up/down/SPS
====  ========  =======  ========  ========  ==================  ==============
0     2.40 MS/s 240 kS/s 48 kHz    10        1/5                 247/960, SPS 26
1     1.44 MS/s 288 kS/s 48 kHz    5         1/6                 (no RDS)
2     2.40 MS/s 240 kS/s 44.1 kHz  10        147/800             817/1920, SPS 43
3     0.96 MS/s 320 kS/s 44.1 kHz  3         441/3200            (no RDS)
====  ========  =======  ========  ========  ==================  ==============

The port's own copy of ``sdr_tpu/config.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class Mode(enum.IntEnum):
    MODE_0 = 0
    MODE_1 = 1
    MODE_2 = 2
    MODE_3 = 3


# Fixed cutoffs shared by all modes (src/project.cpp:45,157,172-173;
# model/fmRDS.py:122-124).
RF_FC_HZ = 100_000.0
AUDIO_FC_HZ = 16_000.0
PILOT_BPF_HZ = (18_500.0, 19_500.0)
STEREO_BPF_HZ = (22_000.0, 54_000.0)
RDS_CHANNEL_BPF_HZ = (54_000.0, 60_000.0)
RDS_CARRIER_BPF_HZ = (113_500.0, 114_500.0)
RDS_RESAMPLER_FC_HZ = 3_000.0

# PLL targets (src/project.cpp:237; model/fmRDS.py:236-237).
PILOT_FREQ_HZ = 19_000.0
RDS_CARRIER_FREQ_HZ = 114_000.0

# RDS symbol rate: 1187.5 bit/s differentially-Manchester coded -> 2375 sym/s
# (model/fmSupportLib.py:264 T_symbol = 1/2375).
RDS_SYMBOL_RATE = 2375.0

# Default tap counts (model/stereo.py:74-78, model/fmRDS.py:93-100).  The C++
# benchmark build project.cpp uses reduced 13-tap filters; the shipping path
# threadMonoOnly.cpp uses 151/101 like the Python model — we use the latter.
RF_TAPS = 151
AUDIO_TAPS_BASE = 101
STEREO_TAPS = 151
RDS_TAPS = 151
RDS_RRC_TAPS = 101


@dataclasses.dataclass(frozen=True)
class RdsConfig:
    """RDS-path resampling parameters (model/fmRDS.py:57-71)."""

    upsamp: int
    decim: int
    sps: int  # samples per symbol after the rational resampler
    rrc_taps: int = RDS_RRC_TAPS

    @property
    def resampler_taps(self) -> int:
        return AUDIO_TAPS_BASE * self.upsamp

    @property
    def symbol_fs(self) -> float:
        """Sample rate at the RRC filter input: SPS * 2375."""
        return self.sps * RDS_SYMBOL_RATE


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """All static parameters of one receiver mode."""

    mode: Mode
    rf_fs: float
    if_fs: float
    audio_fs: float
    rf_decim: int
    audio_decim: int
    audio_upsamp: int  # 1 for the integer-decimation modes
    rds: Optional[RdsConfig]

    rf_taps: int = RF_TAPS
    stereo_taps: int = STEREO_TAPS
    rds_taps: int = RDS_TAPS

    @property
    def audio_taps(self) -> int:
        """Mono/stereo LPF taps: 101, scaled by U for rational modes
        (model/stereo.py:63-71)."""
        return AUDIO_TAPS_BASE * self.audio_upsamp

    @property
    def audio_lpf_fs(self) -> float:
        """Design rate of the audio LPF: the (virtually) upsampled IF rate."""
        return self.if_fs * self.audio_upsamp

    def if_block_multiple(self, with_rds: bool = False) -> int:
        """Smallest IF-sample count that keeps every decimator integral.

        The IF block length must be divisible by ``audio_decim`` (so the
        mono/stereo resampler emits a whole number of samples) and, when the
        RDS path runs, by ``rds.decim / gcd`` as well.
        """
        m = self.audio_decim // math.gcd(self.audio_decim, self.audio_upsamp)
        if with_rds and self.rds is not None:
            r = self.rds.decim // math.gcd(self.rds.decim, self.rds.upsamp)
            m = m * r // math.gcd(m, r)
        return m

    def default_block_size(self, with_rds: bool = False) -> int:
        """Default raw-IQ block size (u8 count, I+Q interleaved).

        Chosen like the reference (model/stereo.py:114-119) to be a multiple
        of every decimation factor, sized for ~1 k audio samples per block on
        the integer modes.
        """
        if_mult = self.if_block_multiple(with_rds)
        if_len = if_mult
        # target on the order of 5k-10k IF samples per block
        while if_len < 5_000:
            if_len += if_mult
        return if_len * self.rf_decim * 2

    @property
    def audio_out_per_if(self) -> tuple[int, int]:
        """(numerator, denominator) audio samples per IF sample."""
        return self.audio_upsamp, self.audio_decim


_MODES = {
    Mode.MODE_0: ModeConfig(
        mode=Mode.MODE_0, rf_fs=2.40e6, if_fs=240e3, audio_fs=48e3,
        rf_decim=10, audio_decim=5, audio_upsamp=1,
        rds=RdsConfig(upsamp=247, decim=960, sps=26),
    ),
    Mode.MODE_1: ModeConfig(
        mode=Mode.MODE_1, rf_fs=1.44e6, if_fs=288e3, audio_fs=48e3,
        rf_decim=5, audio_decim=6, audio_upsamp=1, rds=None,
    ),
    Mode.MODE_2: ModeConfig(
        mode=Mode.MODE_2, rf_fs=2.40e6, if_fs=240e3, audio_fs=44.1e3,
        rf_decim=10, audio_decim=800, audio_upsamp=147,
        rds=RdsConfig(upsamp=817, decim=1920, sps=43),
    ),
    Mode.MODE_3: ModeConfig(
        mode=Mode.MODE_3, rf_fs=0.96e6, if_fs=320e3, audio_fs=44.1e3,
        rf_decim=3, audio_decim=3200, audio_upsamp=441, rds=None,
    ),
}


def get_mode_config(mode: int | Mode) -> ModeConfig:
    return _MODES[Mode(mode)]


def custom_mode(rf_fs: float, if_fs: float, audio_fs: float,
                rds: Optional[RdsConfig] = None, **overrides) -> ModeConfig:
    """Build a ModeConfig for sample rates outside the four group-28 modes.

    Decimation/resampling factors are derived from the rates: ``rf_fs``
    must be an integer multiple of ``if_fs``, and the audio resampler runs
    at the reduced rational ``audio_fs / if_fs``.  Extra keyword arguments
    override tap counts (``rf_taps``, ``stereo_taps``, ``rds_taps``).
    """
    rf_decim = int(round(rf_fs / if_fs))
    if abs(rf_fs - rf_decim * if_fs) > 1e-6:
        raise ValueError(f"rf_fs {rf_fs} must be an integer multiple of "
                         f"if_fs {if_fs}")
    from fractions import Fraction
    frac = Fraction(int(round(audio_fs)), int(round(if_fs)))
    upsamp, decim = frac.numerator, frac.denominator
    return ModeConfig(
        mode=Mode.MODE_0,  # mode tag is informational for custom configs
        rf_fs=rf_fs, if_fs=if_fs, audio_fs=audio_fs, rf_decim=rf_decim,
        audio_decim=decim, audio_upsamp=upsamp, rds=rds, **overrides)
