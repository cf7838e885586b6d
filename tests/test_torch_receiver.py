"""The port's receiver (process_block, Receiver) against the JAX package's.

Mode-0 stereo+RDS on raw u8, CPU: the port's kernel wrappers run their
plain PyTorch versions, and the JAX package's Pallas kernels run in
interpret mode.  Tolerances are those of tests/test_models_receiver.py:
2e-4 on fm_demod/mono, 5e-3 on the PLL-driven left/right/RDS arms (the PLL
lock transient amplifies ulp differences; here XLA's FMA contraction on
the CPU against the port's op-by-op rounding).  The RF tails are exact
normalized bytes and must be equal.
"""

import numpy as np
import pytest
import torch

from torch_parity import (BS, MC, PMC, SHORT, TPU_SELECTORS,
                          assert_close, capture, mode0_batch, np_of,
                          run_both)  # noqa: F401

from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import fir_frontend, pll_cuda


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("kernels,fused", [
    ("cpu_default", None),     # JAX's CPU selection; the port's policy (K2)
    ("tpu", True),             # the TPU's selection, mixer-fused PLL (K3)
    ("tpu", False),            # the TPU's selection, angle PLL (K2)
])
def test_process_block_stereo_rds(capture, c, kernels, fused):
    """Two chained 115,200-byte blocks of the main path.  ``kernels`` picks
    the JAX package's selection; the port has one path, whose wrappers run
    their plain versions on the CPU."""
    if kernels == "cpu_default":
        jsel, psel = jrx.auto_kernel_selectors(), {}
    else:
        jsel = dict(TPU_SELECTORS, fused_mixer=fused)
        psel = dict(fused_mixer=fused)
    batch = (c,) if c > 1 else ()
    run_both(mode0_batch(capture, c, 2 * BS), 2, BS, True, True, jsel, psel,
              batch)


def test_fused_mixer_policy_matches_jax():
    for batch in (1, 2, 256, 512, 1024):
        for arms in (1, 2):
            assert prx.fused_mixer_policy(batch, arms) == \
                jrx.fused_mixer_policy(batch, arms)


@pytest.mark.parametrize("c,kernel", [(1, "pll_angles"), (1024, "pll_mixer")])
def test_process_block_goes_through_kernel_wrappers(monkeypatch, c, kernel):
    """process_block has one path: u8 input reaches K1's wrapper and the
    PLLs reach K2's or K3's, as the lane policy says, whatever the
    device.  One 960-sample block."""
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapper)

    spy(fir_frontend, "fir_frontend_u8")
    for name in ("pll_angles", "pll_mixer"):
        spy(pll_cuda, name)
    batch = (c,) if c > 1 else ()
    iq = torch.full(batch + (SHORT,), 128, dtype=torch.uint8)
    iq[..., ::7] = 200
    out, _ = prx.process_block(iq, prx.design_coeffs(PMC),
                               prx.init_state(PMC, batch), PMC, True, True)
    assert calls == ["fir_frontend_u8", kernel]
    assert out.left.shape == batch + (SHORT // 100,)


def test_init_state_matches_jax():
    for batch in ((), (3,)):
        ps, js = prx.init_state(PMC, batch), jrx.init_state(MC, batch)
        for name in ps._fields:
            a, b = getattr(ps, name), getattr(js, name)
            for x, y in (zip(a, b) if hasattr(a, "_fields") else [(a, b)]):
                np.testing.assert_array_equal(np_of(x), np_of(y), name)


class TestReceiver:
    def test_run_equals_process_loop(self, capture):
        iq = capture[:3 * SHORT]
        r1 = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
        outs = r1.run(iq, block_size=SHORT)
        r2 = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
        for b in range(3):
            o = r2.process(iq[b * SHORT:(b + 1) * SHORT])
            for f in o._fields:
                np.testing.assert_array_equal(np_of(getattr(outs, f)[b]),
                                              np_of(getattr(o, f)))
        assert outs.left.shape == (3, SHORT // 100)

    def test_batched_run_layout(self, capture):
        """A (C, T) recording runs as (n_blocks, C, ...) outputs, and each
        channel equals its own single-channel run."""
        iq = mode0_batch(capture, 2, 2 * SHORT)
        rb = prx.Receiver(0, stereo=True, with_rds=True, batch_shape=(2,),
                          device="cpu")
        outs = rb.run(iq, block_size=SHORT)
        assert outs.left.shape == (2, 2, SHORT // 100)
        r1 = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
        one = r1.run(iq[1], block_size=SHORT)
        assert_close(outs.left[:, 1], one.left, 1e-5)
        assert_close(outs.rds_symbols[:, 1], one.rds_symbols, 1e-5)

    def test_run_rejects_short_capture(self):
        """A capture shorter than one block makes no block: every arm
        comes back empty with the JAX package's shape, the state as it
        was."""
        r = prx.Receiver(0, device="cpu")
        state = r.state
        outs = r.run(np.zeros(100, np.uint8))
        want = jrx.Receiver(0).run(np.zeros(100, np.uint8))
        for name in outs._fields:
            assert tuple(getattr(outs, name).shape) == \
                getattr(want, name).shape, name
        assert r.state is state

    def test_receiver_turns_tf32_off(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        prx.Receiver(0, device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
