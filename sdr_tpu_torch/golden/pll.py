"""Golden PLL + NCO (numpy, per-sample loop — this is the oracle, not the
fast path; on the card the port runs the CUDA kernels of ops.pll_cuda).

Reference: ``fmPll`` model/fmSupportLib.py:297-353 (C++ src/filter.cpp:32-80).
Second-order type-2 loop: atan2 phase detector, PI loop filter
(Cp=2.666, Ci=3.555 for damping 0.707), NCO with frequency ``freq`` and an
output tap at ``nco_scale`` times the locked frequency (+``phase_adjust``).

The NCO emits N+1 samples per N-sample block: index 0 is the carried last
output of the previous block (state[4]/state[6]); the mixers then consume
``nco[:-1]`` (model/stereo.py:226, model/fmRDS.py:241) — i.e. the NCO output
is effectively delayed by one sample relative to the PLL input.  We keep that
contract exactly.

The port's own copy of ``sdr_tpu/golden/pll.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Loop-filter scale factors for damping factor 1/sqrt(2), unity oscillator and
# detector gain (model/fmSupportLib.py:303-309).
_CP = 2.666
_CI = 3.555


@dataclasses.dataclass
class PllState:
    """7-element PLL carry (model/fmRDS.py:173 init [0,0,1,0,1,0,1])."""

    integrator: float = 0.0
    phase_est: float = 0.0
    feedback_i: float = 1.0
    feedback_q: float = 0.0
    nco_last: float = 1.0
    trig_offset: float = 0.0
    nco_q_last: float = 1.0

    def copy(self) -> "PllState":
        return dataclasses.replace(self)


def fm_pll(pll_in: np.ndarray, freq: float, fs: float, state: PllState,
           nco_scale: float = 2.0, phase_adjust: float = 0.0,
           norm_bandwidth: float = 0.01) -> tuple[np.ndarray, np.ndarray, PllState]:
    """Run the PLL over one block.  Returns (nco_i, nco_q, new_state) where
    the NCO arrays have len(pll_in)+1 entries (see module docstring)."""
    kp = norm_bandwidth * _CP
    ki = norm_bandwidth * norm_bandwidth * _CI
    w = 2.0 * math.pi * freq / fs

    n = len(pll_in)
    nco_i = np.empty(n + 1)
    nco_q = np.empty(n + 1)
    nco_i[0] = state.nco_last
    nco_q[0] = state.nco_q_last

    integ = state.integrator
    phase = state.phase_est
    fb_i = state.feedback_i
    fb_q = state.feedback_q
    trig = state.trig_offset

    for k in range(n):
        err_i = pll_in[k] * fb_i
        err_q = pll_in[k] * (-fb_q)
        err_d = math.atan2(err_q, err_i)
        integ += ki * err_d
        phase += kp * err_d + integ
        trig += 1.0
        arg = w * trig + phase
        fb_i = math.cos(arg)
        fb_q = math.sin(arg)
        nco_i[k + 1] = math.cos(arg * nco_scale + phase_adjust)
        nco_q[k + 1] = math.sin(arg * nco_scale + phase_adjust)

    new_state = PllState(integ, phase, fb_i, fb_q, nco_i[-1], trig, nco_q[-1])
    return nco_i, nco_q, new_state
