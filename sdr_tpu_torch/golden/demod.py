"""Golden FM discriminators (numpy, vectorized).

* ``fm_demod_quad``   — the computationally-efficient derivative discriminator
  (ref: model/fmSupportLib.py:466-500 ``compEffDemod``; C++ ``fmDemod``
  src/filter.cpp:248-266).  Zero-power samples emit 0, matching the C++ guard
  (src/filter.cpp:254-255; the Python model only zeroes the 0/0 NaN case —
  we take the C++ semantics as normative since 0-power is degenerate anyway).
* ``fm_demod_arctan`` — atan2 + phase-unwrap discriminator
  (ref: model/fmSupportLib.py:502-531).

The port's own copy of ``sdr_tpu/golden/demod.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def fm_demod_quad(i: np.ndarray, q: np.ndarray,
                  prev_iq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Derivative discriminator: (I*dQ - Q*dI) / (I^2 + Q^2).

    ``prev_iq`` is the 2-element [I[-1], Q[-1]] carry from the previous block.
    Returns (fm_demod, new_prev_iq).
    """
    ip = np.concatenate([prev_iq[:1], i[:-1]])
    qp = np.concatenate([prev_iq[1:2], q[:-1]])
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    with np.errstate(invalid="ignore", divide="ignore"):
        y = np.where(den == 0.0, 0.0, num / den)
    return y, np.array([i[-1], q[-1]])


def fm_demod_arctan(i: np.ndarray, q: np.ndarray,
                    prev_phase: float = 0.0) -> tuple[np.ndarray, float]:
    """atan2 discriminator with unwrap (ref: model/fmSupportLib.py:502-531)."""
    phase = np.arctan2(q, i)
    full = np.unwrap(np.concatenate([[prev_phase], phase]))
    y = np.diff(full)
    # carry the *unwrapped* last phase so the next block stays continuous
    return y, float(full[-1])
