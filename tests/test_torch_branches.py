"""Every other branch of the port's process_block against the JAX
package's: mono only, one PLL arm (stereo or RDS alone: K3 in the port,
against the JAX package's K3 or its plain single PLL), the quadrature RDS
debug arm (K2), and float input.

CPU only; tolerances as in tests/test_torch_receiver.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import (MC, SHORT, TPU_SELECTORS,
                          assert_close, capture, mode0_batch, np_of,
                          run_both)  # noqa: F401

from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch.models import receiver as prx


@pytest.mark.parametrize("stereo,with_rds,debug_q,kernels", [
    (False, False, False, True),   # mono only
    (True, False, False, True),    # stereo, one PLL arm: K3 on both sides
    (True, False, False, False),   # stereo: JAX's plain single PLL
    (False, True, False, True),    # RDS only, one PLL arm: K3 on both sides
    (False, True, False, False),   # RDS only: JAX's plain single PLL
    (True, True, True, True),      # the quadrature debug arm: K2
])
def test_process_block_branches(capture, stereo, with_rds, debug_q,
                                kernels):
    """Every other branch of process_block, on three short blocks.
    ``kernels`` picks the JAX package's selection: the TPU's Pallas
    kernels (interpreted) or its CPU default."""
    jsel = dict(TPU_SELECTORS if kernels else jrx.auto_kernel_selectors(),
                rds_debug_q=debug_q)
    run_both(mode0_batch(capture, 1, 3 * SHORT), 3, SHORT, stereo, with_rds,
              jsel, dict(rds_debug_q=debug_q))


def test_single_pll_unfused(capture):
    """One PLL arm with the mixer-fused kernel turned off: the port's
    single-PLL K2 path against the JAX package's plain single PLL."""
    run_both(mode0_batch(capture, 1, 2 * SHORT), 2, SHORT, True, False,
              jrx.auto_kernel_selectors(), dict(fused_mixer=False))


def test_float_input_matches_u8(capture):
    """Normalized float input takes K5 (its plain fp32 FIR on the CPU);
    the u8 front-end computes the same filter of the same exact values."""
    iq = capture[:SHORT]
    fl = (iq.astype(np.float32) - 128.0) / 128.0
    pc = prx.design_coeffs(MC)
    o8, s8 = prx.process_block(torch.from_numpy(iq), pc, prx.init_state(MC),
                               MC, True, True)
    of, sf = prx.process_block(torch.from_numpy(fl), pc, prx.init_state(MC),
                               MC, True, True)
    assert_close(of.fm_demod, o8.fm_demod, 1e-6)
    np.testing.assert_array_equal(np_of(sf.rf_i), np_of(s8.rf_i))
