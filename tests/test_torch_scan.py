"""``models.run_blocks_scan``, runs of zero blocks and the arms' shape
function of the port, against the JAX package's.

* ``block_out_lengths`` against ``jax.eval_shape`` of the JAX package's
  ``process_block`` in every mode, mono, stereo, stereo+RDS and with the
  RDS debug arm;
* zero blocks (a capture shorter than one block) through ``run_blocks``,
  ``run_blocks_scan``, ``Receiver.run`` and ``channel_sharded_run``: the
  JAX package's shapes and dtypes exactly, and the state as it came;
* ``run_blocks_scan`` on a mode-0 stereo+RDS station against the JAX
  package's at the receiver tolerances (FM_ATOL on fm_demod/mono,
  PLL_ARM_ATOL on the PLL-driven arms: tests/test_models_receiver.py),
  against ``run_blocks`` bit for bit, the caller's state untouched, and
  the states of two calls independent.

K (``SCAN_BLOCKS``) is set to 3, so 4 blocks of 19,200 bytes make a chunk
and a tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FM_ATOL, MC, PLL_ARM_ATOL, PMC, SHORT,
                          assert_close, np_of)

from sdr_tpu import config as cfg
from sdr_tpu.models import receiver as jrx
from sdr_tpu.parallel import channel as jch
from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.parallel import channel as pch
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import synth

ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")
# (stereo, with_rds, rds_debug_q)
VARIANTS = {"mono": (False, False, False), "stereo": (True, False, False),
            "stereo_rds": (True, True, False),
            "rds_debug_q": (True, True, True)}
SHORT_CAPTURE = 100     # bytes: less than one block in every mode


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=0.05, mode=0, with_stereo=True,
                               with_rds=True, seed=29).iq_u8


@pytest.fixture
def k3(monkeypatch):
    monkeypatch.setattr(prx, "SCAN_BLOCKS", 3)


def _equal(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in
               zip(pprog.tree_leaves(a), pprog.tree_leaves(b)))


def _clone(tree):
    return pprog.tree_map(torch.clone, tree)


def _same_shapes(port, jax_out) -> None:
    """Every arm of the port's outputs has the JAX package's shape, and
    both are float32."""
    for name in port._fields:
        p, j = getattr(port, name), getattr(jax_out, name)
        assert tuple(p.shape) == tuple(j.shape), name
        assert p.dtype == torch.float32 and j.dtype == jnp.float32, name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", range(4))
def test_block_out_lengths_match_jax_eval_shape(mode, variant):
    stereo, rds, debug_q = VARIANTS[variant]
    mc = cfg.get_mode_config(mode)
    bs = mc.default_block_size(rds)
    out, _ = jax.eval_shape(
        lambda x, c, s: jrx.process_block(x, c, s, mc, stereo, rds,
                                          rds_debug_q=debug_q),
        jax.ShapeDtypeStruct((bs,), jnp.uint8), jrx.design_coeffs(mc),
        jrx.init_state(mc))
    got = prx.block_out_lengths(pcfg.get_mode_config(mode), bs, stereo, rds,
                                debug_q)
    assert tuple(got) == tuple(o.shape[-1] for o in out)


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("mode,stereo,rds", [(1, False, False),
                                             (0, True, True)])
def test_zero_blocks_run_blocks_and_scan(mode, stereo, rds, lead):
    """``run_blocks`` and ``run_blocks_scan`` over (0, ..., block) input:
    the JAX scan's shapes and dtypes; ``run_blocks`` hands the state back
    as it came, ``run_blocks_scan`` a copy of it."""
    mc, pmc = cfg.get_mode_config(mode), pcfg.get_mode_config(mode)
    bs = mc.default_block_size(rds)
    jo, js = jrx.run_blocks_scan(jnp.zeros((0,) + lead + (bs,), jnp.uint8),
                                 jrx.design_coeffs(mc),
                                 jrx.init_state(mc, lead), mode, stereo, rds)
    blocks = torch.zeros((0,) + lead + (bs,), dtype=torch.uint8)
    pc, ps = prx.design_coeffs(pmc), prx.init_state(pmc, lead)
    before = _clone(ps)
    po, st = prx.run_blocks(blocks, pc, ps, pmc, stereo, rds)
    _same_shapes(po, jo)
    assert st is ps and _equal(st, before)
    so, st2 = prx.run_blocks_scan(blocks, pc, ps, mode, stereo, rds)
    _same_shapes(so, jo)
    assert _equal(st2, before) and _equal(ps, before)
    assert all(a.numel() == 0 or a.data_ptr() != b.data_ptr() for a, b in
               zip(pprog.tree_leaves(st2), pprog.tree_leaves(ps)))
    for a, b in zip(pprog.tree_leaves(st2), pprog.tree_leaves(js)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))


@pytest.mark.parametrize("mode,stereo,rds,batch", [
    (1, False, False, ()), (0, True, True, (2,))])
def test_zero_blocks_receiver_run(mode, stereo, rds, batch):
    """``Receiver.run`` on a capture shorter than one block returns what
    the JAX package's does and leaves the state as it was."""
    x = np.arange(SHORT_CAPTURE, dtype=np.uint8)
    x = np.broadcast_to(x, batch + x.shape).copy()
    jo = jrx.Receiver(mode, stereo=stereo, with_rds=rds,
                      batch_shape=batch).run(x)
    r = prx.Receiver(mode, stereo=stereo, with_rds=rds, batch_shape=batch,
                     device="cpu")
    state, before = r.state, _clone(r.state)
    po = r.run(x)
    _same_shapes(po, jo)
    assert r.state is state and _equal(r.state, before)
    assert list(r.iter_run(x)) == []


def test_zero_blocks_channel_sharded_run():
    """4 channels over two CPU shards: each shard's empty outputs (0, 2,
    out_len) and its initial state, the JAX package's over two devices."""
    x = np.zeros((4, SHORT_CAPTURE), np.uint8)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("ch",))
    jo, js = jch.channel_sharded_run(x, mesh, 1, stereo=False)
    shards = pch.channel_sharded_run(x, Mesh(["cpu"] * 2, ("ch",)), 1,
                                     stereo=False)
    init = prx.init_state(pcfg.get_mode_config(1), (2,))
    for out, st in zip(shards.outputs, shards.states):
        for name in out._fields:
            assert tuple(getattr(out, name).shape) == \
                (0, 2) + getattr(jo, name).shape[2:], name
            assert getattr(out, name).device.type == "cpu"
        assert _equal(st, init)
    outs, state = pch.gather_channels(shards)
    _same_shapes(outs, jo)
    for a, b in zip(pprog.tree_leaves(state), pprog.tree_leaves(js)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))


def test_run_blocks_scan_matches_jax_and_run_blocks(station, k3):
    """4 blocks (a chunk of 3 and a tail) of a mode-0 stereo+RDS station:
    against the JAX package's ``run_blocks_scan`` at the receiver
    tolerances, against ``run_blocks`` bit for bit; the caller's state is
    not modified, and a second call (``mode`` as a ``Mode``, then as a
    ``ModeConfig``) leaves the first call's results as they were."""
    n = 4
    blocks = np.ascontiguousarray(station[:n * SHORT].reshape(n, SHORT))
    jo, js = jrx.run_blocks_scan(jnp.asarray(blocks), jrx.design_coeffs(MC),
                                 jrx.init_state(MC), 0, True, True)
    pc, ps = prx.design_coeffs(PMC), prx.init_state(PMC)
    before = _clone(ps)
    po, st = prx.run_blocks_scan(torch.from_numpy(blocks), pc, ps, 0, True,
                                 True)
    assert _equal(ps, before)
    for arm in ARMS:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(po, arm), getattr(jo, arm), tol, arm)
    np.testing.assert_array_equal(np_of(st.rf_i), np.asarray(js.rf_i))
    np.testing.assert_array_equal(np_of(st.rf_q), np.asarray(js.rf_q))

    ro, rs = prx.run_blocks(torch.from_numpy(blocks), pc,
                            prx.init_state(PMC), PMC, True, True)
    assert _equal(po, ro) and _equal(st, rs)

    kept_out, kept_state = _clone(po), _clone(st)
    prog = prx._scan_program(PMC, True, True)
    keys = prog.keys()
    for mode in (pcfg.Mode(0), PMC):
        po2, st2 = prx.run_blocks_scan(torch.from_numpy(blocks), pc, st,
                                       mode, True, True)
        assert _equal(po, kept_out) and _equal(st, kept_state)
        assert not _equal(po2, po)      # the second run carries on
    assert prog.keys() == keys          # the first call's program, kept
    # a state of its own each call: chaining from the first call's state
    # twice gives the same result
    assert _equal(st2, prx.run_blocks_scan(torch.from_numpy(blocks), pc,
                                           st, 0, True, True)[1])
