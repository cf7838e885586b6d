"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, and the Pallas
kernel runs in interpret mode, as tests/test_pallas.py runs it.

Tolerances:
* K1: the port keeps full fp32 taps, where the TPU kernel splits them into
  bf16 hi + lo halves (~2^-17 relative weight error), so outputs agree to
  ~1e-6 and are held at 1e-5; the carried tails are exact (normalized
  bytes) and must be equal.
* K2/K3: the Pallas body runs the same float32 operations, but XLA on the
  CPU contracts its multiply-adds into FMAs while the port rounds each on
  its own (as its CUDA kernel does), so angles and NCO values differ by
  ulps (held at 1e-5; the integrator at 1e-6) and a mixer product of a
  unit-variance operand at 1e-4.

The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the GPU
machine.
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
from sdr_tpu.models import receiver as jrx
from sdr_tpu.ops import pallas_fir_mxu as pfm
from sdr_tpu.ops import pallas_pll as ppll
from sdr_tpu.ops import pll as jpll
from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.stimulus import pll_tones
from sdr_tpu_torch.ops import fir_frontend, pll_cuda
from sdr_tpu_torch.ops import pll as tpll

K1_ATOL = 1e-5
NCO_ATOL = 1e-5
MIX_ATOL = 1e-4
PLL_TOLS = {"integrator": 1e-6, "phase_est": NCO_ATOL, "osc_phase": NCO_ATOL,
            "feedback_i": NCO_ATOL, "feedback_q": NCO_ATOL,
            "nco_last": NCO_ATOL, "nco_q_last": NCO_ATOL}

t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
j32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)


def _rf_taps() -> np.ndarray:
    mc = cfg.get_mode_config(0)
    return gfilt.lowpass_taps(mc.rf_taps, mc.rf_fs, cfg.RF_FC_HZ).astype(
        np.float32)


def _u8_case(rng, c: int, n: int, k: int = 151):
    u8 = rng.integers(0, 256, size=(c, 2 * n), dtype=np.uint8)
    st = (rng.integers(-128, 128, size=(c, 2, k - 1)).astype(np.float32)
          / 128.0)
    return u8, st


class TestFrontendK1:
    @pytest.mark.parametrize("n,c", [
        (57600, 2),    # the mode-0 block: 115,200 bytes, D = 10
        (140, 1),      # N < K-1: the new tail keeps part of the state
    ])
    def test_plain_matches_pallas(self, n, c):
        rng = np.random.default_rng(n + c)
        h = _rf_taps()
        u8, st = _u8_case(rng, c, n)
        jy, js = pfm.fir_frontend_u8_pallas_int(
            jnp.asarray(u8), j32(h), j32(st), 10, interpret=True)
        ty, ts = fir_frontend.fir_frontend_u8(torch.from_numpy(u8), t32(h),
                                              t32(st), 10)
        assert ty.shape == (c, 2, n // 10)
        assert_close(ty, jy, K1_ATOL)
        np.testing.assert_array_equal(np_of(ts), np_of(js))

    def test_four_block_chain(self):
        rng = np.random.default_rng(4)
        h = _rf_taps()
        n = 5760
        u8, _ = _u8_case(rng, 2, 4 * n)
        js = jnp.zeros((2, 2, 150), jnp.float32)
        ts = torch.zeros((2, 2, 150))
        parts = []
        for b in range(4):
            blk = u8[:, b * 2 * n:(b + 1) * 2 * n]
            jy, js = pfm.fir_frontend_u8_pallas_int(
                jnp.asarray(blk), j32(h), js, 10, interpret=True)
            ty, ts = fir_frontend.fir_frontend_u8(
                torch.from_numpy(np.ascontiguousarray(blk)), t32(h), ts, 10)
            assert_close(ty, jy, K1_ATOL)
            np.testing.assert_array_equal(np_of(ts), np_of(js))
            parts.append(np_of(ty))
        # chained blocks == one long block (overlap-save)
        whole, _ = fir_frontend.fir_frontend_u8(
            torch.from_numpy(u8), t32(h), torch.zeros((2, 2, 150)), 10)
        assert_close(np.concatenate(parts, -1), whole, 1e-6)

    def test_plain_is_the_exact_fir_of_normalized_bytes(self):
        """Against the float64 golden FIR of (x - 128) / 128."""
        rng = np.random.default_rng(8)
        h = _rf_taps()
        u8, st = _u8_case(rng, 1, 4000)
        ty, _ = fir_frontend.fir_frontend_u8(torch.from_numpy(u8), t32(h),
                                             t32(st), 10)
        x = (u8[0].astype(np.float64) - 128.0) / 128.0
        for a in range(2):
            gy, _ = gfilt.block_fir_decim(x[a::2], h.astype(np.float64),
                                          st[0, a].astype(np.float64), 10)
            assert_close(ty[0, a], gy, 1e-6)

    @pytest.mark.parametrize("bad", ["dtype", "state_shape", "ragged"])
    def test_rejects_bad_operands(self, bad):
        h = t32(_rf_taps())
        iq = torch.zeros((1, 2 * 100), dtype=torch.uint8)
        st = torch.zeros((1, 2, 150))
        if bad == "dtype":
            iq = iq.float()
        elif bad == "state_shape":
            st = torch.zeros((1, 150))
        else:
            iq = torch.zeros((1, 2 * 105), dtype=torch.uint8)
        with pytest.raises((TypeError, ValueError)):
            fir_frontend.fir_frontend_u8(iq, h, st, 10)

    def test_other_device_raises(self):
        """Only a CPU tensor takes the plain version: a tensor on another
        device launches the kernel or raises."""
        iq = torch.zeros((1, 200), dtype=torch.uint8, device="meta")
        with pytest.raises(RuntimeError):
            fir_frontend.fir_frontend_u8(iq, torch.zeros(151),
                                         torch.zeros((1, 2, 150)), 10)


def _states(c: int):
    js = jax.tree.map(lambda a, b: jnp.broadcast_to(
        jnp.stack([a, b], axis=-1), (c, 2)),
        jpll.pll_init(), jpll.pll_init(nco_q_last=1.0))
    ts = tpll.PllState(*[torch.stack([a, b], -1).expand(c, 2).clone()
                         for a, b in zip(tpll.pll_init(),
                                         tpll.pll_init(nco_q_last=1.0))])
    return js, ts


class TestPllK2:
    def test_fused_pair_three_blocks(self):
        p, pp = pll_params()
        x = pll_tones(11, 1, 3 * 1920, MC.if_fs)
        js, ts = _states(1)
        for b in range(3):
            xb = x[..., b * 1920:(b + 1) * 1920]
            ji, jq, js = ppll.pll_block_fused_pallas(j32(xb), js, p,
                                                     interpret=True)
            ti, tq, ts = pll_cuda.pll_block_fused_kernel(t32(xb), ts, pp)
            assert ti.shape == (1, 2, 1921)
            assert_close(ti, ji, NCO_ATOL)
            assert_close(tq, jq, NCO_ATOL)
            assert_tuple_close(ts, js, PLL_TOLS)

    def test_single_arm_matches_plain_loop(self):
        """pll_block_kernel on the CPU is the plain loop of ops.pll, so it
        must equal ops.pll.pll_block exactly."""
        _, (q1, _) = pll_params()
        x = t32(np.random.default_rng(5).standard_normal((3, 700)))
        st = tpll.PllState(*[l.expand(3).clone() for l in tpll.pll_init()])
        a = pll_cuda.pll_block_kernel(x, st, q1)
        b = tpll.pll_block(x, st, q1)
        for u, v in zip(a[:2], b[:2]):
            np.testing.assert_array_equal(np_of(u), np_of(v))
        assert_tuple_close(a[2], b[2], 0.0)

    def test_rejects_mismatched_carry(self):
        with pytest.raises(ValueError):
            pll_cuda.pll_angles(torch.zeros((10, 4)), torch.zeros((4, 3)),
                                torch.zeros((4, 4)))
        with pytest.raises(ValueError):
            pll_cuda.pll_mixer(torch.zeros((10, 4)), torch.zeros((10, 3)),
                               torch.zeros((6, 4)), torch.zeros((6, 4)))

    def test_other_device_raises(self):
        xs = torch.zeros((10, 4), device="meta")
        with pytest.raises(RuntimeError):
            pll_cuda.pll_angles(xs, torch.zeros((4, 4), device="meta"),
                                torch.zeros((4, 4), device="meta"))


class TestPllK3:
    def test_two_arms_chained(self):
        p, pp = pll_params()
        rng = np.random.default_rng(21)
        x = pll_tones(21, 1, 3 * 1920, MC.if_fs)
        mix = rng.standard_normal((1, 2, 3 * 1920)).astype(np.float32)
        js, ts = _states(1)
        for b in range(3):
            sl = slice(b * 1920, (b + 1) * 1920)
            jm, js = ppll.pll_mixer_fused_pallas(
                j32(x[..., sl]), j32(mix[..., sl]), js, p, interpret=True)
            tm, ts = pll_cuda.pll_mixer_fused_kernel(
                t32(x[..., sl]), t32(mix[..., sl]), ts, pp)
            assert tm.shape == (1, 2, 1920)
            assert_close(tm, jm, MIX_ATOL)
            assert_tuple_close(ts, js, PLL_TOLS)

    def test_one_arm_batched_partial_tile(self):
        """K = 1 with a batch of 3 and a length that is not a multiple of
        the Pallas time tile."""
        (p1, _), (q1, _) = pll_params()
        rng = np.random.default_rng(22)
        x = rng.standard_normal((3, 1, 1000)).astype(np.float32)
        mix = rng.standard_normal((3, 1, 1000)).astype(np.float32)
        js = jax.tree.map(lambda l: jnp.broadcast_to(l, (3, 1)),
                          jpll.pll_init())
        ts = tpll.PllState(*[l.expand(3, 1).clone() for l in tpll.pll_init()])
        jm, js = ppll.pll_mixer_fused_pallas(j32(x), j32(mix), js, (p1,),
                                             interpret=True)
        tm, ts = pll_cuda.pll_mixer_fused_kernel(
            t32(x), t32(mix), ts, (q1,))
        assert_close(tm, jm, MIX_ATOL)
        assert_tuple_close(ts, js, PLL_TOLS)

    def test_equals_unfused_path(self):
        """K3's plain version == K2's plain version + nco[:-1] * mix * 2,
        bitwise, including the carried state."""
        _, pp = pll_params()
        rng = np.random.default_rng(23)
        x = t32(pll_tones(23, 2, 800, MC.if_fs))
        mix = t32(rng.standard_normal((2, 2, 800)))
        _, st = _states(2)
        nco, _, s2 = pll_cuda.pll_block_fused_kernel(x, st, pp)
        m3, s3 = pll_cuda.pll_mixer_fused_kernel(x, mix, st, pp)
        np.testing.assert_array_equal(np_of(m3),
                                      np_of(nco[..., :-1] * mix * 2.0))
        assert_tuple_close(s3, s2, 0.0)


class TestBuild:
    def test_library_path_is_keyed_by_sources(self):
        p = build.library_path()
        assert p == build.library_path()
        assert p.parent.parent == build.BUILD_ROOT
        assert {s.name for s in build._sources()} == {"fir_decim.cu",
                                                      "halo.cu", "pll.cu"}

    def test_check_raises_on_error_code(self):
        build.check(0, "k")
        with pytest.raises(RuntimeError):
            build.check(2, "k")
