"""FM discriminators (port of ``sdr_tpu/ops/demod.py``).

The only cross-sample dependency is a one-sample delay, carried as a
2-element (I, Q) state (quadrature) or the last phase (arctan).
"""

from __future__ import annotations

import math

import torch


def fm_demod_quad(i: torch.Tensor, q: torch.Tensor, prev_iq: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Derivative discriminator (I*dQ - Q*dI)/(I^2+Q^2); zero power -> 0.
    Supports leading batch dims; returns (y, new_prev (..., 2))."""
    ip = torch.cat([prev_iq[..., 0:1], i[..., :-1]], dim=-1)
    qp = torch.cat([prev_iq[..., 1:2], q[..., :-1]], dim=-1)
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    zero = den == 0.0
    y = torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))
    new_prev = torch.stack([i[..., -1], q[..., -1]], dim=-1)
    return y, new_prev


def fm_demod_arctan(i: torch.Tensor, q: torch.Tensor,
                    prev_phase: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """atan2 discriminator: each output is the difference of consecutive
    instantaneous phases wrapped into [-pi, pi) (``torch.remainder``
    takes the divisor's sign, as ``jnp.mod`` does).  Supports leading
    batch dims; returns (y, last phase)."""
    phase = torch.atan2(q, i)
    prev = torch.cat([prev_phase[..., None], phase[..., :-1]], dim=-1)
    y = torch.remainder(phase - prev + math.pi, 2 * math.pi) - math.pi
    return y, phase[..., -1]
