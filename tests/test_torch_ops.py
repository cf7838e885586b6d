"""sdr_tpu_torch.ops (plain PyTorch) against sdr_tpu.ops (JAX on the CPU).

Tolerances: the FIRs are fp32 sums taken in another order than XLA's (the
JAX forms run at Precision.HIGH), so outputs of unit-scale inputs agree to
~1e-7 and are held at 2e-6; carried tails are copies of inputs and must be
equal.  The PLL loop does the JAX scan's float32 operations in the same
order, but XLA on the CPU contracts its multiply-adds (``integ + ki*err``,
``phase + kp*err``, the wrap) into FMAs, while the port rounds each
operation on its own, as its CUDA kernels do.  So the carry differs from
the first block on by ulps: the integrator (up to ~0.1) by an ulp or two,
held at 1e-6; the angles, up to 8*pi where an ulp is 1.9e-6, and the
cos/sin of them (two math libraries, which also differ by an ulp) are held
at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (MC, assert_close, assert_tuple_close, np_of,
                          pll_params)

from sdr_tpu import config as cfg
from sdr_tpu.golden import filters as gfilt
from sdr_tpu.ops import demod as jdemod
from sdr_tpu.ops import fir as jfir
from sdr_tpu.ops import pll as jpll
from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch.ops import demod as tdemod
from sdr_tpu_torch.ops import fir as tfir
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.stimulus import pll_tones

FIR_ATOL = 2e-6
NCO_ATOL = 1e-5
INTEG_ATOL = 1e-6

t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
j32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)


class TestFir:
    @pytest.mark.parametrize("decim,taps,n,lead", [
        (10, 151, 4000, ()),      # RF-like
        (5, 101, 5760, (2,)),     # mode-0 audio LPF, batched
        (1, 101, 1482, ()),       # unit stride: the RRC after the resampler
        (10, 151, 140, (1,)),     # block shorter than K-1
    ])
    def test_decim_mm(self, decim, taps, n, lead):
        rng = np.random.default_rng(100 + n)
        h = gfilt.lowpass_taps(taps, 2.4e6, 100e3)
        x = rng.normal(size=lead + (n,))
        st = rng.normal(size=lead + (taps - 1,))
        jy, js = jfir.fir_block_decim_mm(j32(x), j32(h), j32(st), decim)
        ty, ts = tfir.fir_block_decim_mm(t32(x), t32(h), t32(st), decim)
        assert ty.shape == jy.shape
        assert_close(ty, jy, FIR_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))

    def test_decim_rejects_ragged_block(self):
        with pytest.raises(ValueError):
            tfir.fir_block_decim_mm(torch.zeros(15), torch.ones(5),
                                    torch.zeros(4), 10)

    def test_multi_three_band(self):
        """The stereo/pilot/RDS-channel band-passes of mode 0 in one call."""
        mc = cfg.get_mode_config(0)
        jc = jrx.design_coeffs(mc)
        hs = np.stack([np_of(jc.stereo), np_of(jc.pilot),
                       np_of(jc.rds_channel)])
        rng = np.random.default_rng(7)
        x = rng.normal(size=(2, 5760))
        st = rng.normal(size=(2, 150))
        jy, js = jfir.fir_block_multi_mm(j32(x), j32(hs), j32(st))
        ty, ts = tfir.fir_block_multi_mm(t32(x), t32(hs), t32(st))
        assert ty.shape == (2, 3, 5760)
        assert_close(ty, jy, FIR_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))

    @pytest.mark.parametrize("n,taps,decim,upsamp", [
        (5760, 101 * 247, 960, 247),   # mode-0 RDS resampler, banded form
        (1002, 31, 4, 2),              # n % decim != 0: gather fallback
    ])
    def test_resample(self, n, taps, decim, upsamp):
        rng = np.random.default_rng(n)
        h = gfilt.lowpass_taps(taps, 240e3 * upsamp, 3e3)
        x = rng.normal(size=(2, n))
        t = gfilt.resample_state_len(taps, upsamp)
        st = rng.normal(size=(2, t))
        jy, js = jfir.fir_block_resample_mm(j32(x), j32(h), j32(st), decim,
                                            upsamp)
        ty, ts = tfir.fir_block_resample_mm(t32(x), t32(h), t32(st), decim,
                                            upsamp)
        assert ty.shape == jy.shape == (2, n * upsamp // decim)
        assert_close(ty, jy, FIR_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))
        # the gather form is the same filter
        gy, gs = tfir.fir_block_resample(t32(x), t32(h), t32(st), decim,
                                         upsamp)
        assert_close(gy, jy, FIR_ATOL)
        np.testing.assert_array_equal(np_of(gs), np_of(js))

    def test_resample_matches_golden_chain(self):
        """Chained blocks of the banded resampler against the float64
        golden model (the JAX form's own oracle)."""
        rng = np.random.default_rng(3)
        u, d, taps = 247, 960, 101 * 247
        h = gfilt.lowpass_taps(taps, 240e3 * u, 3e3)
        x = rng.normal(size=3 * 960)
        gst = np.zeros(gfilt.resample_state_len(taps, u))
        tst = t32(gst)
        for b in range(3):
            xb = x[b * 960:(b + 1) * 960]
            gy, gst = gfilt.block_fir_resample(xb, h, gst, d, u)
            ty, tst = tfir.fir_block_resample_mm(t32(xb), t32(h), tst, d, u)
            assert_close(ty, gy, 2e-5)

    def test_allpass_delay(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3, 500))
        st = rng.normal(size=(3, 75))
        jy, js = jfir.allpass_delay(j32(x), j32(st))
        ty, ts = tfir.allpass_delay(t32(x), t32(st))
        np.testing.assert_array_equal(np_of(ty), np_of(jy))
        np.testing.assert_array_equal(np_of(ts), np_of(js))


class TestDemod:
    def test_quad_with_zero_power(self):
        rng = np.random.default_rng(9)
        i = rng.normal(size=(2, 300))
        q = rng.normal(size=(2, 300))
        i[:, 10:14] = 0.0
        q[:, 10:14] = 0.0          # zero power: the output must be 0
        prev = np.zeros((2, 2))    # zero power at the block edge too
        jy, js = jdemod.fm_demod_quad(j32(i), j32(q), j32(prev))
        ty, ts = tdemod.fm_demod_quad(t32(i), t32(q), t32(prev))
        assert np.all(np_of(ty)[:, 10:14] == 0.0)
        assert np.isfinite(np_of(ty)).all()
        assert_close(ty, jy, 1e-6)
        np.testing.assert_array_equal(np_of(ts), np_of(js))


NCO_TOLS = {"integrator": INTEG_ATOL, "phase_est": NCO_ATOL,
            "osc_phase": NCO_ATOL,
            "feedback_i": NCO_ATOL, "feedback_q": NCO_ATOL,
            "nco_last": NCO_ATOL, "nco_q_last": NCO_ATOL}


class TestPll:
    def test_params(self):
        for p, q in zip(*pll_params()):
            assert tuple(q) == tuple(p)
            assert q.wrap_modulus == p.wrap_modulus

    def test_fused_pair_three_blocks(self):
        """pilot (19 kHz) + RDS carrier (114 kHz) in one loop, chained over
        three 1,920-sample blocks."""
        (p1, p2), pp = pll_params()
        x = pll_tones(11, 1, 3 * 1920, MC.if_fs)[0]
        js = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=-1),
                          jpll.pll_init(), jpll.pll_init(nco_q_last=1.0))
        ts = tpll.PllState(*[torch.stack([a, b], -1) for a, b in zip(
            tpll.pll_init(), tpll.pll_init(nco_q_last=1.0))])
        for b in range(3):
            xb = x[:, b * 1920:(b + 1) * 1920]
            ji, jq, js = jpll.pll_block_fused(j32(xb), js, (p1, p2))
            ti, tq, ts = tpll.pll_block_fused(t32(xb), ts, pp)
            assert ti.shape == (2, 1921)
            assert_close(ti, ji, NCO_ATOL)
            assert_close(tq, jq, NCO_ATOL)
            assert_tuple_close(ts, js, NCO_TOLS)

    def test_single_batched_three_blocks(self):
        """One PLL over a batch of 3 channels, chained over three blocks."""
        (p1, _), (q1, _) = pll_params()
        rng = np.random.default_rng(12)
        x = rng.standard_normal((3, 3 * 1920)).astype(np.float32)
        js = jax.tree.map(lambda l: jnp.broadcast_to(l, (3,)),
                          jpll.pll_init())
        ts = tpll.PllState(*[l.expand(3).clone() for l in tpll.pll_init()])
        for b in range(3):
            xb = x[:, b * 1920:(b + 1) * 1920]
            ji, jq, js = jpll.pll_block(j32(xb), js, p1)
            ti, tq, ts = tpll.pll_block(t32(xb), ts, q1)
            assert_close(ti, ji, NCO_ATOL)
            assert_close(tq, jq, NCO_ATOL)
            assert_tuple_close(ts, js, NCO_TOLS)

    def test_zero_input_detector(self):
        """x == 0 takes the IEEE atan2-of-signed-zero branch."""
        (p1, _), (q1, _) = pll_params()
        x = np.zeros(64, np.float32)
        x[::3] = 0.5
        ji, jq, js = jpll.pll_block(j32(x), jpll.pll_init(), p1)
        ti, tq, ts = tpll.pll_block(t32(x), tpll.pll_init(), q1)
        assert_close(ti, ji, NCO_ATOL)
        assert_tuple_close(ts, js, NCO_TOLS)
