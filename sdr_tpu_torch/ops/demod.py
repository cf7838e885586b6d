"""FM quadrature discriminator (port of ``sdr_tpu/ops/demod.py``).

The only cross-sample dependency is a one-sample delay, carried as a
2-element (I, Q) state.
"""

from __future__ import annotations

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
