"""Kernels K5 and K4 of the port against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, and the Pallas
kernels run in interpret mode, as tests/test_pallas.py runs them.

Tolerances:
* K5 (``fir_block_decim``, plain: the fp32 banded matmul) against
  ``fir_decim_pallas``/``fir_block_decim_pallas``: 2e-5, the gate of
  tests/test_pallas.py (two fp32 summation orders); carried tails equal.
* K4 (``fir_frontend_u8_deinterleaved``, plain: K1's) against
  ``fir_frontend_u8_pallas``: 1e-5 (the TPU kernel's bf16 hi/lo weight
  split is ~2^-17 relative, the port keeps fp32 taps); tails equal.

The CUDA kernels against these plain versions are in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, np_of

from sdr_tpu import config as cfg
from sdr_tpu.golden import filters as gfilt
from sdr_tpu.ops import pallas_fir
from sdr_tpu.ops import pallas_fir_mxu as pfm
from sdr_tpu_torch.ops import fir_decim, fir_frontend

K5_ATOL = 2e-5
K4_ATOL = 1e-5

t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
j32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)


def _taps(fs: float, fc: float) -> np.ndarray:
    return gfilt.lowpass_taps(151, fs, fc).astype(np.float32)


@pytest.mark.parametrize("decim", [3, 4, 5, 10])
def test_k5_plain_matches_pallas_batched(decim):
    """A (2, 3) batch of rows; D = 3 is mode 3's RF decimation (51
    polyphase rows of 151 taps), 4 the channelizer's at 9.6 MS/s."""
    rng = np.random.default_rng(decim)
    h = _taps(decim * 240e3, 100e3)
    x = rng.standard_normal((2, 3, 96 * decim)).astype(np.float32)
    st = rng.standard_normal((2, 3, 150)).astype(np.float32)
    jy, js = pallas_fir.fir_block_decim_pallas(j32(x), j32(h), j32(st),
                                               decim, interpret=True)
    ty, ts = fir_decim.fir_block_decim(t32(x), t32(h), t32(st), decim)
    assert ty.shape == (2, 3, 96)
    assert_close(ty, jy, K5_ATOL)
    np.testing.assert_array_equal(np_of(ts), np_of(js))


@pytest.mark.parametrize("decim", [3, 4, 5, 10])
def test_k5_plain_matches_pallas_chained(decim):
    """Three chained blocks, each side carrying its own tail; the first
    block is shorter than K-1, so its tail keeps part of the state."""
    rng = np.random.default_rng(10 + decim)
    h = _taps(decim * 240e3, 100e3)
    js = jnp.zeros((2, 150), jnp.float32)
    ts = torch.zeros((2, 150))
    for n in (12 * decim, 200 * decim, 64 * decim):
        x = rng.standard_normal((2, n)).astype(np.float32)
        jy, js = pallas_fir.fir_block_decim_pallas(j32(x), j32(h), js, decim,
                                                   interpret=True)
        ty, ts = fir_decim.fir_block_decim(t32(x), t32(h), ts, decim)
        assert_close(ty, jy, K5_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))


def test_k5_plain_matches_pallas_on_the_extended_input():
    """``fir_decim_pallas`` takes ``[state, x]`` whole: the port's wrapper
    given the same split gives the same outputs."""
    rng = np.random.default_rng(3)
    h = _taps(9.6e6, 1.08e6)
    xc = rng.standard_normal((4, 150 + 4 * 480)).astype(np.float32)
    jy = pallas_fir.fir_decim_pallas(j32(xc), j32(h), 4, interpret=True)
    ty, _ = fir_decim.fir_block_decim(t32(xc[:, 150:]), t32(h),
                                      t32(xc[:, :150]), 4)
    assert_close(ty, jy, K5_ATOL)


def test_k5_reads_the_interleaved_view():
    """The receiver hands K5 the (C, 2, N) view of interleaved I/Q (element
    step 2): the same result as the deinterleaved copy."""
    rng = np.random.default_rng(4)
    h = t32(_taps(2.4e6, 100e3))
    x = torch.tensor(rng.standard_normal((3, 2 * 1200)), dtype=torch.float32)
    view = x.reshape(3, 1200, 2).movedim(-1, -2)
    st = torch.tensor(rng.standard_normal((3, 2, 150)), dtype=torch.float32)
    yv, sv = fir_decim.fir_block_decim(view, h, st, 10)
    yc, sc = fir_decim.fir_block_decim(view.contiguous(), h, st, 10)
    assert torch.equal(yv, yc) and torch.equal(sv, sc)


@pytest.mark.parametrize("n,c", [
    (57600, 2),    # the mode-0 block: 115,200 bytes, D = 10
    (140, 1),      # N < K-1: the new tail keeps part of the state
])
def test_k4_plain_matches_pallas(n, c):
    rng = np.random.default_rng(n + c)
    mc = cfg.get_mode_config(0)
    h = _taps(mc.rf_fs, cfg.RF_FC_HZ)
    u8 = rng.integers(0, 256, size=(c, 2 * n), dtype=np.uint8)
    st = (rng.integers(-128, 128, size=(c, 2, 150)).astype(np.float32)
          / 128.0)
    jy, js = pfm.fir_frontend_u8_pallas(jnp.asarray(u8), j32(h), j32(st),
                                        10, interpret=True)
    ty, ts = fir_frontend.fir_frontend_u8_deinterleaved(
        torch.from_numpy(u8), t32(h), t32(st), 10)
    assert ty.shape == (c, 2, n // 10)
    assert_close(ty, jy, K4_ATOL)
    np.testing.assert_array_equal(np_of(ts), np_of(js))


def test_wrappers_take_the_plain_version_on_cpu_only():
    """On a CPU tensor no kernel launches (the counts stay); any device
    other than CPU and CUDA raises."""
    h = torch.ones(5) / 5
    before = (fir_decim.fir_block_decim.launches,
              fir_frontend.fir_frontend_u8_deinterleaved.launches)
    y, s = fir_decim.fir_block_decim(torch.ones(2, 20), h,
                                     torch.zeros(2, 4), 2)
    assert y.shape == (2, 10) and s.shape == (2, 4)
    fir_frontend.fir_frontend_u8_deinterleaved(
        torch.full((1, 40), 128, dtype=torch.uint8), h, torch.zeros(1, 2, 4),
        2)
    assert (fir_decim.fir_block_decim.launches,
            fir_frontend.fir_frontend_u8_deinterleaved.launches) == before
    with pytest.raises(RuntimeError):
        fir_decim.fir_block_decim(torch.ones(2, 20, device="meta"), h,
                                  torch.zeros(2, 4), 2)
    with pytest.raises(RuntimeError):
        fir_frontend.fir_frontend_u8_deinterleaved(
            torch.zeros(1, 40, dtype=torch.uint8, device="meta"), h,
            torch.zeros(1, 2, 4), 2)


@pytest.mark.parametrize("n,c", [(5760, 2), (140, 1)])
def test_k4_plain_matches_pallas_chained(n, c):
    """Three chained blocks through K4's wrapper and the Pallas kernel, each
    side carrying its own state (the second block shorter than K-1)."""
    rng = np.random.default_rng(7 * n + c)
    h = _taps(cfg.get_mode_config(0).rf_fs, cfg.RF_FC_HZ)
    js = jnp.zeros((c, 2, 150), jnp.float32)
    ts = torch.zeros((c, 2, 150))
    for blk in (n, 140, n):
        u8 = rng.integers(0, 256, size=(c, 2 * blk), dtype=np.uint8)
        jy, js = pfm.fir_frontend_u8_pallas(jnp.asarray(u8), j32(h), js, 10,
                                            interpret=True)
        ty, ts = fir_frontend.fir_frontend_u8_deinterleaved(
            torch.from_numpy(u8), t32(h), ts, 10)
        assert_close(ty, jy, K4_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))
