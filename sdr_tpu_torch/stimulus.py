"""Synthetic inputs shared by ``chip_smoke.py`` and the port's tests.

numpy only, so that the smoke run on the GPU machine and the CPU parity
tests draw the same stimulus from the same seed.
"""

from __future__ import annotations

import numpy as np

#: (pilot-like, RDS-carrier-like) tone frequencies in Hz, a few Hz off the
#: 19 kHz and 114 kHz that the PLLs are tuned to, so the loops must track
PLL_TONE_HZ = (19010.0, 113985.0)
PLL_TONE_AMP = (0.4, 0.1)
PLL_NOISE_STD = 0.02


def pll_tones(seed: int | np.random.Generator, c: int, n: int,
              fs: float) -> np.ndarray:
    """(c, 2, n) float32 PLL inputs at sample rate ``fs``: row 0 the
    pilot-like tone, row 1 the RDS-carrier-like tone, each at a random
    phase, plus Gaussian noise.  ``seed`` may be a Generator, which is
    advanced (the phases are drawn first, then the noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    ph = rng.uniform(0, 2 * np.pi, size=(c, 2, 1))
    f = np.array(PLL_TONE_HZ)[None, :, None]
    amp = np.array(PLL_TONE_AMP)[None, :, None]
    x = amp * np.sin(2 * np.pi * f * t + ph) + PLL_NOISE_STD * (
        rng.standard_normal((c, 2, n)))
    return x.astype(np.float32)
