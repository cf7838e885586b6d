"""The port's one-call ``receive`` and its state/coefficient conversion
against the JAX package, on the CPU.

``receive`` on a 0.3 s synthesized mode-0 stereo+RDS capture: both packages
must decode the same RDS info words, every one of them transmitted, and
their left/right audio must agree within the PLL-arm tolerance of
tests/test_models_receiver.py (5e-3) once the PLLs have locked (after the
first 6,000 audio samples).  Conversion: coefficients must be equal, and a
state from either package must resume in the other, the next block agreeing
within the block tolerances of tests/test_torch_receiver.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (BS, MC, PMC, assert_close, capture, compare_block,
                          np_of)  # noqa: F401

import sdr_tpu
import sdr_tpu_torch
from sdr_tpu import checkpoint as jckpt
from sdr_tpu.models import receiver as jrx
from sdr_tpu.utils import synth
from sdr_tpu_torch import convert
from sdr_tpu_torch.models import receiver as prx

LOCK_SKIP = 6000


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=0.3, mode=0, with_stereo=True,
                               with_rds=True, seed=5)


def test_receive_matches_jax(station):
    port = sdr_tpu_torch.receive(station.iq_u8, mode=0, device="cpu")
    ref = sdr_tpu.receive(station.iq_u8, mode=0)
    assert port.audio_fs == ref.audio_fs
    assert port.left.shape == ref.left.shape == port.right.shape
    assert_close(port.left[LOCK_SKIP:], ref.left[LOCK_SKIP:], 5e-3)
    assert_close(port.right[LOCK_SKIP:], ref.right[LOCK_SKIP:], 5e-3)
    assert_close(port.mono, ref.mono, 2e-4)
    np.testing.assert_array_equal(port.rds_info_words, ref.rds_info_words)
    assert port.rds_frames == ref.rds_frames
    sent = {tuple(w) for g in station.rds_info_bits for w in g}
    assert len(port.rds_info_words) >= 4
    assert all(tuple(w) in sent for w in port.rds_info_words)


def test_receive_keeps_a_short_tail(station):
    """A capture that is not a whole number of blocks: the tail is run as a
    final smaller block, not dropped (mono only: no PLL, fast)."""
    n = BS + 19_200
    out = sdr_tpu_torch.receive(station.iq_u8[:n], mode=0, stereo=False,
                                rds=False, device="cpu")
    assert out.left is None and out.rds_info_words.shape == (0, 16)
    assert out.mono.shape == (n // 2 // 50,)
    with pytest.raises(ValueError):
        sdr_tpu_torch.receive(station.iq_u8[:1000], mode=0, device="cpu")


def test_coeffs_from_jax_equal_design():
    got = convert.coeffs_from_numpy(jrx.design_coeffs(MC))
    want = prx.design_coeffs(PMC)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_state_layout_is_the_checkpoint_layout():
    ps = prx.init_state(PMC, (2,))
    flat = convert.state_to_numpy(ps)
    jflat = jckpt._flatten_with_paths(jrx.init_state(MC, (2,)))
    assert list(flat) == list(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k], k)
    back = convert.state_from_numpy(flat)
    for k, v in convert.state_to_numpy(back).items():
        np.testing.assert_array_equal(v, flat[k], k)


def _jax_state(flat):
    template = jrx.init_state(MC)
    import jax
    leaves = [jnp.asarray(flat[k]) for k in jckpt._flatten_with_paths(
        template)]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def test_state_resumes_across_packages(capture):
    """Block 1 in one package, block 2 in the other, both ways."""
    pc, jc = prx.design_coeffs(PMC), jrx.design_coeffs(MC)
    b1 = capture[:BS]
    b2 = capture[BS:2 * BS]
    _, ps = prx.process_block(torch.from_numpy(b1), pc, prx.init_state(PMC),
                              PMC, True, True)
    _, js = jrx.process_block(jnp.asarray(b1), jc, jrx.init_state(MC), MC,
                              True, True)
    # JAX state -> port block 2 == JAX block 2
    ps_from_j = convert.state_from_numpy(jckpt._flatten_with_paths(js),
                                         expect_input_dtype="uint8")
    po, ps2 = prx.process_block(torch.from_numpy(b2), pc, ps_from_j, PMC,
                                True, True)
    jo, js2 = jrx.process_block(jnp.asarray(b2), jc, js, MC, True, True)
    compare_block(po, jo, ps2, js2)
    # port state -> JAX block 2 == port block 2
    js_from_p = _jax_state(convert.state_to_numpy(ps))
    jo, js2 = jrx.process_block(jnp.asarray(b2), jc, js_from_p, MC, True,
                                True)
    po, ps2 = prx.process_block(torch.from_numpy(b2), pc, ps, PMC, True,
                                True)
    compare_block(po, jo, ps2, js2)


def test_u8_resume_rejects_float_state():
    flat = convert.state_to_numpy(prx.init_state(PMC))
    flat["rf_i"] = flat["rf_i"] + np.float32(0.3 / 128)
    with pytest.raises(ValueError):
        convert.state_from_numpy(flat, expect_input_dtype="uint8")
    convert.state_from_numpy(flat, expect_input_dtype="float32")
    with pytest.raises(ValueError):
        prx.validate_u8_rf_state(torch.tensor(flat["rf_i"]),
                                 torch.tensor(flat["rf_q"]))
