"""The PLL + NCO recurrence in plain PyTorch (port of ``sdr_tpu/ops/pll.py``).

A second-order type-2 PLL whose per-sample recurrence is sequential in
time.  Here it is a Python loop over time on tensors that carry every
batch dimension, so all channels and PLL arms step together.
:func:`pll_args_loop` is the plain version of the CUDA kernels in
``sdr_tpu_torch.ops.pll_cuda``; :func:`pll_block` and
:func:`pll_block_fused` keep the JAX package's contracts around it and are
the reference the parity tests hold against ``sdr_tpu.ops.pll``.

The oscillator phase and phase estimate are carried wrapped modulo
``2*pi*q`` (``PllParams.wrap_modulus``), where ``q`` is the smallest integer
making ``q * nco_scale`` integral, so the carried phase stays O(1).  The
wrap is ``torch.remainder`` (the port of ``jnp.mod``); ``torch.fmod``
would differ for negative values.

The phase detector is transcendental-free: for a real input ``x`` the
reference's ``atan2(x*(-sin a), x*cos a)`` is exactly ``wrap_pi(-a)`` for
x > 0, ``wrap_pi(pi - a)`` for x < 0, and the IEEE atan2 of signed zeros
for x == 0.  So the loop needs only adds, compares and selects, and every
cos/sin runs once over the whole block outside it.  ``pll_block(...,
use_atan2=True)`` keeps the literal recurrence for A/B validation.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

# Loop-filter constants for damping 1/sqrt(2) (same as sdr_tpu.ops.pll).
_CP = 2.666
_CI = 3.555
_PI = math.pi
_TWO_PI = 2.0 * math.pi


class PllParams(NamedTuple):
    freq: float
    fs: float
    nco_scale: float = 2.0
    phase_adjust: float = 0.0
    norm_bandwidth: float = 0.01

    @property
    def wrap_modulus(self) -> float:
        q = 1
        while (q * self.nco_scale) % 1.0 != 0.0:
            q += 1
            if q > 64:
                raise ValueError(f"nco_scale {self.nco_scale} not rational "
                                 "with small denominator")
        return 2.0 * math.pi * q


class PllState(NamedTuple):
    integrator: torch.Tensor
    phase_est: torch.Tensor   # wrapped mod M
    osc_phase: torch.Tensor   # wrapped 2*pi*f/fs * trigOffset, mod M
    feedback_i: torch.Tensor
    feedback_q: torch.Tensor
    nco_last: torch.Tensor
    nco_q_last: torch.Tensor


def pll_init(nco_last: float = 1.0, nco_q_last: float = 0.0,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str | None = None) -> PllState:
    """Initial state matching the reference's [0,0,1,0,1,0,(q0)]."""
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return PllState(f(0.0), f(0.0), f(0.0), f(1.0), f(0.0),
                    f(nco_last), f(nco_q_last))


def stack_arms(states: Sequence[PllState]) -> PllState:
    """Several PLLs' states as one, arms on a new last axis."""
    return PllState(*[torch.stack(leaves, dim=-1) for leaves in zip(*states)])


def arm(state: PllState, i: int) -> PllState:
    """Arm ``i`` of a state made by :func:`stack_arms`."""
    return PllState(*[leaf[..., i] for leaf in state])


def loop_constants(params_seq: Sequence[PllParams], dtype: torch.dtype,
                   device: torch.device | str) -> dict[str, torch.Tensor]:
    """Per-arm loop constants as (K,) tensors.  Each is computed in float64
    on the host and rounded once to ``dtype``, as the JAX package does.

    Made once per (params, dtype, device) and kept on the device for the
    life of the process (:func:`_loop_constants`): a block uploads nothing
    from the host, and a captured block program reads these tensors by
    address.  The dict and its tensors are shared: read them, never write
    them."""
    return _loop_constants(tuple(params_seq), dtype, torch.device(device))


@functools.cache
def _loop_constants(params_seq: tuple[PllParams, ...], dtype: torch.dtype,
                    device: torch.device) -> dict[str, torch.Tensor]:
    vec = lambda vals: torch.tensor(vals, dtype=dtype, device=device)
    return {
        "kp": vec([p.norm_bandwidth * _CP for p in params_seq]),
        "ki": vec([p.norm_bandwidth ** 2 * _CI for p in params_seq]),
        "w": vec([2.0 * math.pi * p.freq / p.fs for p in params_seq]),
        "m": vec([p.wrap_modulus for p in params_seq]),
        "scale": vec([p.nco_scale for p in params_seq]),
        "adj": vec([p.phase_adjust for p in params_seq]),
    }


def pll_args_loop(xs: torch.Tensor, integ: torch.Tensor, phase: torch.Tensor,
                  psi: torch.Tensor, aw: torch.Tensor, kp, ki, w, m
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The recurrence over time-major ``xs`` (N, ...).

    Returns the oscillator angle of every step, ``args`` (N, ...), and the
    final carry ``(integ, phase, psi, aw)`` where ``aw`` is the last angle
    wrapped to [-pi, pi).  The constants broadcast against the carry."""
    args = torch.empty_like(xs)
    # a tensor divisor: on CUDA, PyTorch turns division by a Python scalar
    # into multiplication by its reciprocal, which can round differently
    two_pi = torch.tensor(_TWO_PI, dtype=xs.dtype, device=xs.device)
    for t in range(xs.shape[0]):
        xk = xs[t]
        err_pos = -aw
        err_neg = torch.where(aw > 0, _PI - aw, -_PI - aw)
        err_zero = torch.where(aw.abs() < _PI / 2, 0.0,
                               torch.where(aw > 0, -_PI, _PI))
        err = torch.where(xk > 0, err_pos,
                          torch.where(xk < 0, err_neg, err_zero))
        integ = integ + ki * err
        phase = torch.remainder(phase + kp * err + integ, m)
        psi = torch.remainder(psi + w, m)
        arg = psi + phase
        args[t] = arg
        aw = arg - two_pi * torch.floor(arg / two_pi + 0.5)
    return args, (integ, phase, psi, aw)


def _run(x: torch.Tensor, state: PllState, c: dict
         ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Shared body of :func:`pll_block` and :func:`pll_block_fused`: the
    constants in ``c`` broadcast against the state leaves."""
    xs = x.movedim(-1, 0)          # scan over time, batch dims vectorize
    aw0 = torch.atan2(state.feedback_q, state.feedback_i)
    args, (integ, phase, psi, aw) = pll_args_loop(
        xs, state.integrator, state.phase_est, state.osc_phase, aw0,
        c["kp"], c["ki"], c["w"], c["m"])
    # all trig vectorized over the block, outside the recurrence
    outs_i = torch.cos(args * c["scale"] + c["adj"]).movedim(0, -1)
    outs_q = torch.sin(args * c["scale"] + c["adj"]).movedim(0, -1)
    nco_i = torch.cat([state.nco_last[..., None], outs_i], dim=-1)
    nco_q = torch.cat([state.nco_q_last[..., None], outs_q], dim=-1)
    new_state = PllState(integ, phase, psi, torch.cos(aw), torch.sin(aw),
                         nco_i[..., -1], nco_q[..., -1])
    return nco_i, nco_q, new_state


def _run_atan2(x: torch.Tensor, state: PllState, c: dict
               ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """The reference's literal recurrence: an ``atan2`` phase detector on
    the carried feedback, and the feedback's ``cos``/``sin`` and the NCO's
    evaluated at every step inside the loop."""
    xs = x.movedim(-1, 0)
    integ, phase, psi = state.integrator, state.phase_est, state.osc_phase
    fb_i, fb_q = state.feedback_i, state.feedback_q
    outs_i, outs_q = torch.empty_like(xs), torch.empty_like(xs)
    for t in range(xs.shape[0]):
        xk = xs[t]
        err = torch.atan2(xk * -fb_q, xk * fb_i)
        integ = integ + c["ki"] * err
        phase = torch.remainder(phase + c["kp"] * err + integ, c["m"])
        psi = torch.remainder(psi + c["w"], c["m"])
        arg = psi + phase
        fb_i, fb_q = torch.cos(arg), torch.sin(arg)
        outs_i[t] = torch.cos(arg * c["scale"] + c["adj"])
        outs_q[t] = torch.sin(arg * c["scale"] + c["adj"])
    nco_i = torch.cat([state.nco_last[..., None], outs_i.movedim(0, -1)],
                      dim=-1)
    nco_q = torch.cat([state.nco_q_last[..., None], outs_q.movedim(0, -1)],
                      dim=-1)
    new_state = PllState(integ, phase, psi, fb_i, fb_q, nco_i[..., -1],
                         nco_q[..., -1])
    return nco_i, nco_q, new_state


def pll_block(x: torch.Tensor, state: PllState, params: PllParams,
              use_atan2: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Run one PLL over one block.

    Returns (nco_i, nco_q, new_state); the NCO arrays have ``N+1`` entries
    with index 0 the carried previous output, so mixers use ``nco[..., :-1]``
    as the reference does.  ``x`` (..., N) may carry batch dims, and then
    every state leaf has shape (...).

    ``use_atan2=True`` runs the reference's literal recurrence instead of
    the transcendental-free one, with the same carries, for A/B validation
    as in the JAX package: plain PyTorch on any device, never a kernel (K2
    and K3 compute the transcendental-free form)."""
    c = {k: v[0] for k, v in loop_constants((params,), x.dtype,
                                            x.device).items()}
    return (_run_atan2 if use_atan2 else _run)(x, state, c)


def pll_block_fused(x: torch.Tensor, state: PllState,
                    params_seq: Sequence[PllParams]
                    ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Run K different PLLs in lockstep through one loop.

    ``x`` has shape (..., K, N) with row k driven by ``params_seq[k]``; every
    ``state`` leaf has shape (..., K).  The per-sample math is the same as K
    separate :func:`pll_block` calls, elementwise."""
    k = len(params_seq)
    if x.shape[-2] != k:
        raise ValueError(f"x has {x.shape[-2]} arms, params_seq {k}")
    # time-major (N, ..., K): the (K,) constants broadcast over the arms
    return _run(x, state, loop_constants(params_seq, x.dtype, x.device))
