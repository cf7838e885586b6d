"""The port's wideband channelizer against the JAX package's, on the CPU.

A synthesized 9.6 MS/s capture of two stations (offsets -1.5 and +2.0
MHz, mode 0: decimation 4), three chained blocks, u8 and float input.
Tolerances: the interleaved channel outputs and the FIR tails within 1e-5
(the FIR sums in other orders: XLA's convolution there, the port's fp32
banded matmul here); the carried mixer phase within 1e-6 rad.  The phase
terms are rounded as XLA rounds them on the CPU (one fused multiply-add),
and cos/sin differ by ulps.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_close

from sdr_tpu.models.channelizer import Channelizer as JaxChannelizer
from sdr_tpu.utils import synth
from sdr_tpu_torch.models.channelizer import Channelizer

OFFSETS = [-1.5e6, 2.0e6]
FS = 9.6e6
BLOCK = 2 * 4 * 4800            # wideband bytes: 4,800 I/Q pairs after /4
ATOL = 1e-5


@pytest.fixture(scope="module")
def wideband():
    return synth.synthesize_wideband(duration_s=0.007, fs_wide=FS,
                                     offsets_hz=OFFSETS, mode=0, seed=3)


@pytest.mark.parametrize("dtype", ["u8", "float"])
def test_chained_blocks_match_jax(wideband, dtype):
    iq = wideband.iq_u8[:3 * BLOCK]
    if dtype == "float":
        iq = (iq.astype(np.float32) - 128.0) / 128.0
    jc = JaxChannelizer(OFFSETS, FS, 0)
    pc = Channelizer(OFFSETS, FS, 0)
    assert pc.decim == jc.decim == 4
    for b in range(3):
        blk = iq[b * BLOCK:(b + 1) * BLOCK]
        jo = jc.process(blk)
        po = pc.process(blk)
        assert po.shape == jo.shape == (2, BLOCK // 4)
        assert po.dtype == torch.float32
        assert_close(po, jo, ATOL, f"block {b}")
        assert_close(pc.state.fir, jc.state.fir, ATOL)
        assert_close(pc.state.phi0, jc.state.phi0, 1e-6)


def test_long_block_phase_stays_exact():
    """A block of 2^20 + 3,072 samples: the host float64 phase residues
    keep the carried phase equal to the JAX package's."""
    n = (1 << 20) + 3072
    iq = np.full(2 * n, 0.25, np.float32)
    jc = JaxChannelizer(OFFSETS, FS, 0)
    pc = Channelizer(OFFSETS, FS, 0)
    jc.process(iq)
    pc.process(iq)
    assert_close(pc.state.phi0, jc.state.phi0, 1e-6)
    want = np.mod(2 * np.pi * np.asarray(OFFSETS) / FS * n, 2 * np.pi)
    np.testing.assert_allclose(pc.state.phi0.numpy(), want, atol=1e-6)


def test_channelizer_refuses_bad_rates_and_blocks():
    with pytest.raises(ValueError):
        Channelizer(OFFSETS, 9.5e6, 0)       # not a multiple of 2.4 MS/s
    pc = Channelizer(OFFSETS, FS, 0)
    with pytest.raises(ValueError):
        pc.process(np.zeros(2 * 4 * 100 + 2, np.uint8))   # N % 4 != 0


def test_state_dtypes_and_device():
    pc = Channelizer(OFFSETS, FS, 0, device="cpu")
    assert pc.state.fir.shape == (2, 2, 150)
    assert pc.state.phi0.shape == (2,)
    out = pc.process(torch.zeros(2 * 400, dtype=torch.float64))
    assert out.device.type == "cpu" and out.shape == (2, 200)
    assert out.dtype == pc.state.fir.dtype == torch.float32
