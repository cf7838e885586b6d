"""Test-signal generators (reference src/genfunc.cpp).

``generate_sin`` (src/genfunc.cpp:13-21), ``add_sin`` multi-tone
composition (:23-31), ``random_samples`` (:33-41) — used by unit tests and
benchmarks; the full FM-station synthesizer lives in
sdr_tpu_torch.utils.synth.

The port's own copy of ``sdr_tpu/utils/gen.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def generate_sin(fs: float, f: float, n: int, amplitude: float = 1.0,
                 phase: float = 0.0) -> np.ndarray:
    t = np.arange(n) / fs
    return amplitude * np.sin(2 * np.pi * f * t + phase)


def add_sin(fs: float, freqs, n: int, amplitudes=None, phases=None
            ) -> np.ndarray:
    freqs = list(freqs)
    amplitudes = list(amplitudes) if amplitudes else [1.0] * len(freqs)
    phases = list(phases) if phases else [0.0] * len(freqs)
    out = np.zeros(n)
    for f, a, p in zip(freqs, amplitudes, phases):
        out += generate_sin(fs, f, n, a, p)
    return out


def random_samples(n: int, max_value: float = 10.0,
                   seed: int | None = None) -> np.ndarray:
    """Uniform random test vectors (src/genfunc.cpp:33-41)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-max_value, max_value, n)
