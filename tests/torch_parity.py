"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package
(on the CPU; Pallas kernels in interpret mode) and through the port, and
the results are compared as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu import config as cfg
from sdr_tpu.models import receiver as jrx
from sdr_tpu.utils import synth
from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch.models import receiver as prx

# tier-1 runs several pytest workers on one host: one thread each
torch.set_num_threads(1)


def np_of(x) -> np.ndarray:
    """A JAX array or a torch tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, atol: float, err_msg: str = "") -> None:
    np.testing.assert_allclose(np_of(port), np_of(ref), rtol=0, atol=atol,
                               err_msg=err_msg)


def assert_tuple_close(port, ref, atol: float | dict) -> None:
    """Field by field; ``atol`` may map field names to tolerances, and a
    tolerance of 0 demands equality."""
    for name in port._fields:
        tol = atol.get(name, 0.0) if isinstance(atol, dict) else atol
        a, b = getattr(port, name), getattr(ref, name)
        if hasattr(a, "_fields"):
            assert_tuple_close(a, b, tol)
        elif tol == 0.0:
            np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=name)
        else:
            assert_close(a, b, tol, err_msg=name)


# --- PLL parameters -------------------------------------------------------


def pll_params():
    """Mode 0's (pilot, RDS carrier) PLL parameters: the JAX package's and
    the port's."""
    jp = (jrx.pilot_pll_params(MC), jrx.rds_pll_params(MC))
    return jp, (prx.pilot_pll_params(PMC), prx.rds_pll_params(PMC))


# --- receiver parity (mode 0, raw u8) ---------------------------------

FM_ATOL = 2e-4
PLL_ARM_ATOL = 5e-3


def mode_configs(mode: int = 0, **custom) -> tuple:
    """One mode in both packages: (the JAX package's ``ModeConfig``, the
    port's), of mode number ``mode`` or, given keyword arguments, each
    package's ``custom_mode(**custom)``.  The port is never handed the
    JAX package's config."""
    if custom:
        return cfg.custom_mode(**custom), pcfg.custom_mode(**custom)
    return cfg.get_mode_config(mode), pcfg.get_mode_config(mode)


MC, PMC = mode_configs(0)
BS = MC.default_block_size(True)          # 115,200 bytes = 5,760 IF samples
SHORT = 19_200                            # 960 IF samples, one RDS period

TPU_SELECTORS = dict(mxu_fir=True, pallas_frontend=True, pallas_pll=True)


@pytest.fixture(scope="module")
def capture():
    return synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                               with_rds=True, seed=11).iq_u8


def mode0_batch(iq: np.ndarray, c: int, n_bytes: int) -> np.ndarray:
    """c channels: the capture from 0, 2*19200, 4*19200, ... bytes."""
    if c == 1:
        return iq[:n_bytes]
    return np.stack([iq[2 * SHORT * k: 2 * SHORT * k + n_bytes]
                     for k in range(c)])


def compare_block(po, jo, ps, js):
    assert_close(po.fm_demod, jo.fm_demod, FM_ATOL, "fm_demod")
    assert_close(po.mono, jo.mono, FM_ATOL, "mono")
    for f in ("left", "right", "rds_symbols", "rds_symbols_q"):
        assert getattr(po, f).shape == getattr(jo, f).shape, f
        assert_close(getattr(po, f), getattr(jo, f), PLL_ARM_ATOL, f)
    np.testing.assert_array_equal(np_of(ps.rf_i), np_of(js.rf_i))
    np.testing.assert_array_equal(np_of(ps.rf_q), np_of(js.rf_q))


def run_port(iq, n_blocks, block, stereo, with_rds, psel=None, batch=(),
             mc=PMC) -> list:
    """Chain ``n_blocks`` blocks of ``iq`` through the port's
    ``process_block`` (``mc``: the port's config); returns [(outputs,
    state)] per block."""
    pc, ps = prx.design_coeffs(mc), prx.init_state(mc, batch)
    res = []
    for b in range(n_blocks):
        blk = np.ascontiguousarray(iq[..., b * block:(b + 1) * block])
        po, ps = prx.process_block(torch.from_numpy(blk), pc, ps, mc, stereo,
                                   with_rds, **(psel or {}))
        res.append((po, ps))
    return res


def run_both(iq, n_blocks, block, stereo, with_rds, jsel, psel,
             batch=(), mcs=(MC, PMC), port=None):
    """Chain ``n_blocks`` blocks of ``iq`` through both packages'
    ``process_block`` (mode 0 unless ``mcs``, a :func:`mode_configs` pair,
    says otherwise) and compare every block.  ``jsel`` are the JAX
    package's keyword arguments (its kernel selectors among them); the
    port has one path, so ``psel`` holds only
    ``rds_debug_q``/``fused_mixer``.  ``port`` reuses a
    :func:`run_port` result of the same blocks."""
    mc, pmc = mcs
    port = port or run_port(iq, n_blocks, block, stereo, with_rds, psel,
                            batch, pmc)
    jc, js = jrx.design_coeffs(mc), jrx.init_state(mc, batch)
    for b, (po, ps) in enumerate(port):
        blk = iq[..., b * block:(b + 1) * block]
        jo, js = jrx.process_block(jnp.asarray(blk), jc, js, mc, stereo,
                                   with_rds, **jsel)
        compare_block(po, jo, ps, js)
