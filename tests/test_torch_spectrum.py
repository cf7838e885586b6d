"""sdr_tpu_torch.ops.spectrum, ``fm_demod_arctan`` and the ``ops`` exports
against sdr_tpu.ops (JAX on the CPU) and sdr_tpu.golden, with seeded numpy
inputs.

Tolerances, those of tests/test_ops.py or tighter: the DFT and the
DFT -> IDFT round trip at atol 1e-3 (complex64 products of unit-scale
inputs over 64-512 points); the PSD at 0.1 dB against the golden float64
estimate, 1e-2 dB between its FFT and matrix-product forms and between
the port and the JAX package in one form; ``fm_demod_arctan`` at 1e-4.
Its phase steps are wrapped into [-pi, pi), so where a step lies within
an ulp of +-pi the two packages may wrap to opposite ends: the FM test
keeps its steps clear of +-pi (at most 0.8 rad), and the random-phase
test compares the difference of the two outputs modulo 2*pi.  The banded
``fir_block``/``fir_block_decim`` against the JAX package's convolution
forms at 2e-6, as tests/test_torch_ops.py holds the FIRs, and their
carried tails equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_of

import sdr_tpu.ops as jops
from sdr_tpu.golden import demod as gdemod
from sdr_tpu.golden import filters as gfilt
from sdr_tpu.golden import spectrum as gspec
from sdr_tpu.ops import demod as jdemod
from sdr_tpu.ops import fir as jfir
from sdr_tpu.ops import spectrum as jspec

import sdr_tpu_torch.ops as pops
from sdr_tpu_torch.ops import demod as pdemod
from sdr_tpu_torch.ops import spectrum as pspec

DFT_ATOL = 1e-3
PSD_GOLDEN_DB = 0.1
PSD_FORMS_DB = 1e-2
ARCTAN_ATOL = 1e-4
FIR_ATOL = 2e-6
FS = 240e3

t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
j32 = lambda a: jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("shape", [(64,), (3, 128), (2, 2, 512)])
def test_dft_matches_jax_and_golden(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape)
    p = np_of(pspec.dft_matmul(t32(x)))
    assert p.dtype == np.complex64
    np.testing.assert_allclose(p, np.asarray(jspec.dft_matmul(j32(x))),
                               atol=DFT_ATOL)
    gold = np.apply_along_axis(gspec.dft, -1, x)
    np.testing.assert_allclose(p, gold, atol=DFT_ATOL)


@pytest.mark.parametrize("n", [128, 512])
def test_idft_matches_jax_and_inverts_the_dft(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    xf = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    p = np_of(pspec.idft_matmul(torch.tensor(xf, dtype=torch.complex64)))
    j = np.asarray(jspec.idft_matmul(jnp.asarray(xf.astype(np.complex64))))
    np.testing.assert_allclose(p, j, atol=DFT_ATOL)
    np.testing.assert_allclose(p[0], gspec.idft(xf[0]), atol=DFT_ATOL)
    back = np_of(pspec.idft_matmul(pspec.dft_matmul(torch.from_numpy(x))))
    np.testing.assert_allclose(np.real(back), x, atol=DFT_ATOL)


def _tone(f: float, n: int, noise: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * f * np.arange(n) / FS)
            + noise * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("use_matmul_dft", [False, True])
def test_psd_matches_jax_and_golden(use_matmul_dft):
    x = _tone(19e3, 8192, 0.01, 3)
    pf, pp = pspec.estimate_psd(t32(x), 512, FS, use_matmul_dft)
    jf, jp = jspec.estimate_psd(j32(x), 512, FS, use_matmul_dft)
    gf, gp = gspec.estimate_psd(x.astype(np.float64), 512, FS)
    assert isinstance(pf, np.ndarray) and isinstance(pp, torch.Tensor)
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_allclose(pf, gf)
    np.testing.assert_allclose(np_of(pp), np.asarray(jp), atol=PSD_FORMS_DB)
    np.testing.assert_allclose(np_of(pp), gp, atol=PSD_GOLDEN_DB)
    assert abs(pf[np.argmax(np_of(pp))] - 19e3) < FS / 512


def test_psd_forms_agree_with_batch_dims():
    """The FFT and matrix-product forms over a (2, n) batch, each row as
    the row alone."""
    x = np.stack([_tone(57e3, 4096, 0.05, 4), _tone(19e3, 4096, 0.05, 5)])
    _, p_fft = pspec.estimate_psd(t32(x), 512, FS)
    _, p_mm = pspec.estimate_psd(t32(x), 512, FS, use_matmul_dft=True)
    assert p_fft.shape == (2, 256)
    np.testing.assert_allclose(np_of(p_mm), np_of(p_fft), atol=PSD_FORMS_DB)
    for r in range(2):
        _, one = pspec.estimate_psd(t32(x[r]), 512, FS)
        np.testing.assert_allclose(np_of(p_fft[r]), np_of(one),
                                   atol=PSD_FORMS_DB)


def test_hann_and_nfft_match_jax():
    assert pspec.NFFT_DEFAULT == jspec.NFFT_DEFAULT
    np.testing.assert_array_equal(pspec.hann_sin2(512), jspec.hann_sin2(512))
    np.testing.assert_array_equal(pspec._dft_matrix(64),
                                  jspec._dft_matrix(64))


def test_fm_demod_arctan_matches_jax_and_golden():
    """30 kHz deviation of a 700 Hz tone at 240 kHz: steps of at most
    0.79 rad, clear of the wrap at +-pi."""
    t = np.arange(3000) / FS
    phase = 2 * np.pi * 30e3 * np.cumsum(np.sin(2 * np.pi * 700 * t)) / FS
    i, q = np.cos(phase), np.sin(phase)
    py, pl = pdemod.fm_demod_arctan(t32(i), t32(q), t32(0.0))
    jy, jl = jdemod.fm_demod_arctan(j32(i), j32(q), j32(0.0))
    gy, _ = gdemod.fm_demod_arctan(i, q, 0.0)
    np.testing.assert_allclose(np_of(py), np.asarray(jy), atol=ARCTAN_ATOL)
    np.testing.assert_allclose(np_of(py), gy, atol=ARCTAN_ATOL)
    np.testing.assert_allclose(np_of(pl), np.asarray(jl), atol=ARCTAN_ATOL)


def test_fm_demod_arctan_random_phases_agree_modulo_2pi():
    """Random I/Q in a (3, 2000) batch with a carried phase: steps land
    anywhere in (-2pi, 2pi), and within an ulp of +-pi either end of the
    wrap is right; the outputs agree modulo 2*pi, and lie in [-pi, pi]."""
    rng = np.random.default_rng(11)
    i, q = rng.normal(size=(2, 3, 2000))
    prev = rng.uniform(-np.pi, np.pi, size=3)
    py, _ = pdemod.fm_demod_arctan(t32(i), t32(q), t32(prev))
    jy, _ = jdemod.fm_demod_arctan(j32(i), j32(q), j32(prev))
    py = np_of(py)
    d = np.remainder(py - np.asarray(jy) + np.pi, 2 * np.pi) - np.pi
    assert np.abs(d).max() <= ARCTAN_ATOL
    assert np.abs(py).max() <= math.pi + 1e-6


def _public(mod) -> set:
    """The names a package exports: public attributes that are not its
    submodules."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, type(jops))}


def test_ops_exports_every_name_of_sdr_tpu_ops():
    want = _public(jops)
    assert len(want) == 12
    assert want <= _public(pops), want - _public(pops)


@pytest.mark.parametrize("decim", [1, 2, 10])
def test_exported_fir_block_forms_match_jax(decim):
    """``ops.fir_block`` (unit stride) and ``ops.fir_block_decim``, the
    banded forms, against the JAX package's convolution forms over a
    batch and a chained second block."""
    rng = np.random.default_rng(decim)
    h = gfilt.lowpass_taps(31, 10.0, 1.0)
    x = rng.normal(size=(2, 2, 640))
    ps, js = t32(np.zeros((2, 30))), j32(np.zeros((2, 30)))
    for b in range(2):
        blk = x[:, b]
        if decim == 1:
            py, ps = pops.fir_block(t32(blk), t32(h), ps)
            jy, js = jfir.fir_block(j32(blk), j32(h), js)
        else:
            py, ps = pops.fir_block_decim(t32(blk), t32(h), ps, decim)
            jy, js = jfir.fir_block_decim(j32(blk), j32(h), js, decim)
        np.testing.assert_allclose(np_of(py), np.asarray(jy), atol=FIR_ATOL)
        np.testing.assert_array_equal(np_of(ps), np.asarray(js))


def test_exported_resample_state_len_matches_jax():
    for taps, up in ((101, 1), (151, 19), (24947, 247)):
        assert pops.resample_state_len(taps, up) == \
            jops.resample_state_len(taps, up)
