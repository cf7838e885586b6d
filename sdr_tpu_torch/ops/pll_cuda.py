"""PLL kernels K2 (angles) and K3 (mixer-fused), with their plain versions.

Port of ``sdr_tpu/ops/pallas_pll.py``:

* :func:`pll_block_fused_kernel` / :func:`pll_block_kernel` are drop-ins
  for ``ops.pll.pll_block_fused`` / ``pll_block`` (the Pallas
  ``pll_block_fused_pallas`` / ``pll_block_pallas``).  The kernel
  :func:`pll_angles` runs the recurrence and emits the oscillator angle of
  every step; cos/sin, the N+1 concat and the new ``PllState`` are computed
  here around it.
* :func:`pll_mixer_fused_kernel` (the Pallas ``pll_mixer_fused_pallas``)
  runs the recurrence, the NCO cos and the mixer product
  ``nco[..., :-1] * mix * 2`` in one kernel, :func:`pll_mixer`, so the NCO
  arrays never reach device memory.

Layout (:class:`LaneLayout`): lanes are (batch x PLL arm), flattened as
``b*K + k``, and time is the leading axis of what the kernels read and
write, so neighbouring threads touch neighbouring addresses at every step.
Per-lane constants are computed in float64 on the host and rounded once, as
the JAX package does.

On a CUDA tensor :func:`pll_angles` and :func:`pll_mixer` launch the
kernels of ``csrc/pll.cu``; on a CPU tensor they run
:func:`pll_angles_plain` / :func:`pll_mixer_plain`, the same recurrence in
plain PyTorch (``ops.pll.pll_args_loop``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops.pll import (PllParams, PllState, loop_constants,
                                   pll_args_loop)

_F32 = torch.float32


# --- plain versions --------------------------------------------------------


def pll_angles_plain(xs: torch.Tensor, carry0: torch.Tensor,
                     consts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: xs (N, L), carry0/consts (4, L) ->
    (args (N, L), carry (4, L)).  Carry rows: integrator, phase estimate,
    oscillator phase, last angle wrapped to [-pi, pi).  Const rows: kp, ki,
    w, modulus."""
    args, carry = pll_args_loop(xs, *carry0[:4], *consts[:4])
    return args, torch.stack(carry)


def pll_mixer_plain(xs: torch.Tensor, mix: torch.Tensor,
                    carry0: torch.Tensor, consts: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: xs, mix (N, L), carry0/consts (6, L) ->
    (mixer (N, L), carry (6, L)).  Rows 4-5 of the carry are the previous
    NCO value and the last angle; rows 4-5 of the constants are the NCO
    scale and phase adjust.  ``mixer[t] = nco[t-1] * mix[t] * 2`` with
    ``nco[-1]`` the carried previous NCO."""
    args, carry = pll_args_loop(xs, *carry0[:4], *consts[:4])
    nco = torch.cos(args * consts[4] + consts[5])
    shifted = torch.cat([carry0[4][None], nco[:-1]], dim=0)
    mixer = shifted * mix * 2.0
    return mixer, torch.stack([*carry, nco[-1], args[-1]])


# --- kernel wrappers -------------------------------------------------------


def _check_lanes(rows: int, xs: torch.Tensor, carry0: torch.Tensor,
                 consts: torch.Tensor, mix: torch.Tensor | None = None
                 ) -> None:
    ops = [xs, carry0, consts] + ([mix] if mix is not None else [])
    for t in ops:
        if t.dtype != _F32:
            raise TypeError(f"PLL kernel operands must be float32, got "
                            f"{t.dtype}")
        if t.device != xs.device:
            raise ValueError("PLL kernel operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("PLL kernel operands must be contiguous")
    if xs.ndim != 2 or xs.numel() == 0:
        raise ValueError(f"xs must be a non-empty (N, lanes) block, got "
                         f"{tuple(xs.shape)}")
    want = (rows, xs.shape[1])
    if tuple(carry0.shape) != want or tuple(consts.shape) != want:
        raise ValueError(f"carry {tuple(carry0.shape)} and constants "
                         f"{tuple(consts.shape)} must be {want}")
    if mix is not None and mix.shape != xs.shape:
        raise ValueError(f"mix {tuple(mix.shape)} != xs {tuple(xs.shape)}")


def pll_angles(xs: torch.Tensor, carry0: torch.Tensor, consts: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: the recurrence's angles (contract of :func:`pll_angles_plain`).
    A CUDA tensor launches the kernel and a CPU tensor takes the plain
    version; any other device raises."""
    _check_lanes(4, xs, carry0, consts)
    if xs.device.type == "cpu":
        return pll_angles_plain(xs, carry0, consts)
    if xs.device.type != "cuda":
        raise RuntimeError(f"no K2 kernel for device {xs.device}")
    n, lanes = xs.shape
    args = torch.empty_like(xs)
    carry = torch.empty_like(carry0)
    lib = build.load()
    with torch.cuda.device(xs.device):
        rc = lib.sdr_pll_angles(
            xs.data_ptr(), carry0.data_ptr(), consts.data_ptr(),
            args.data_ptr(), carry.data_ptr(), n, lanes,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pll_angles")
    pll_angles.launches += 1
    return args, carry


pll_angles.launches = 0


def pll_mixer(xs: torch.Tensor, mix: torch.Tensor, carry0: torch.Tensor,
              consts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: recurrence + NCO cos + mixer (contract of
    :func:`pll_mixer_plain`).  A CUDA tensor launches the kernel and a CPU
    tensor takes the plain version; any other device raises."""
    _check_lanes(6, xs, carry0, consts, mix)
    if xs.device.type == "cpu":
        return pll_mixer_plain(xs, mix, carry0, consts)
    if xs.device.type != "cuda":
        raise RuntimeError(f"no K3 kernel for device {xs.device}")
    n, lanes = xs.shape
    mixer = torch.empty_like(xs)
    carry = torch.empty_like(carry0)
    lib = build.load()
    with torch.cuda.device(xs.device):
        rc = lib.sdr_pll_mixer(
            xs.data_ptr(), mix.data_ptr(), carry0.data_ptr(),
            consts.data_ptr(), mixer.data_ptr(), carry.data_ptr(), n, lanes,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pll_mixer")
    pll_mixer.launches += 1
    return mixer, carry


pll_mixer.launches = 0


# --- drop-ins for ops.pll --------------------------------------------------


class LaneLayout:
    """The kernels' operands for one call: lanes are (batch x arm),
    flattened as ``b*K + k``, and time is the leading axis."""

    _CONST_ROWS = ("kp", "ki", "w", "m", "scale", "adj")

    def __init__(self, x: torch.Tensor, params_seq: Sequence[PllParams]):
        self.k = len(params_seq)
        if x.shape[-2] != self.k:
            raise ValueError(f"x has {x.shape[-2]} arms, params_seq {self.k}")
        self.n = x.shape[-1]
        self.lead = x.shape[:-2]
        self.nl = math.prod(self.lead)
        self.total = self.nl * self.k
        # (K,) per-arm constants repeated over the batch -> (L,)
        self.c = {name: v.repeat(self.nl) for name, v in
                  loop_constants(params_seq, _F32, x.device).items()}

    def time_major(self, a: torch.Tensor) -> torch.Tensor:
        """(..., K, N) -> (N, L), contiguous."""
        return a.reshape(self.total, self.n).t().to(_F32).contiguous()

    def from_time_major(self, a: torch.Tensor) -> torch.Tensor:
        """(N, L) -> (..., K, N)."""
        return a.t().reshape(self.lead + (self.k, self.n))

    def from_lanes(self, a: torch.Tensor) -> torch.Tensor:
        """(L,) -> (..., K)."""
        return a.reshape(self.lead + (self.k,))

    def consts(self, mixer: bool) -> torch.Tensor:
        """(4, L) constants of K2, or (6, L) of K3."""
        rows = self._CONST_ROWS if mixer else self._CONST_ROWS[:4]
        return torch.stack([self.c[r] for r in rows])

    def carry0(self, state: PllState, mixer: bool) -> torch.Tensor:
        """(4, L) initial carry of K2, or (6, L) of K3, from ``state``."""
        aw0 = torch.atan2(state.feedback_q, state.feedback_i)
        rows = [state.integrator, state.phase_est, state.osc_phase, aw0]
        if mixer:
            rows += [state.nco_last, torch.zeros_like(state.nco_last)]
        return torch.stack([r.reshape(self.total).to(_F32) for r in rows])


def pll_block_fused_kernel(x: torch.Tensor, state: PllState,
                           params_seq: Sequence[PllParams]
                           ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Drop-in for ``ops.pll.pll_block_fused`` on K2: ``x`` (..., K, N) with
    row k driven by ``params_seq[k]``, state leaves (..., K).  Returns
    (nco_i, nco_q, new_state) with the N+1 output convention."""
    ly = LaneLayout(x, params_seq)
    args_t, cout = pll_angles(ly.time_major(x), ly.carry0(state, False),
                              ly.consts(False))
    args = ly.from_time_major(args_t)
    scale = ly.from_lanes(ly.c["scale"])[..., None]
    adj = ly.from_lanes(ly.c["adj"])[..., None]
    outs_i = torch.cos(args * scale + adj)
    outs_q = torch.sin(args * scale + adj)
    nco_i = torch.cat([state.nco_last[..., None], outs_i], dim=-1)
    nco_q = torch.cat([state.nco_q_last[..., None], outs_q], dim=-1)
    aw_last = ly.from_lanes(cout[3])
    new_state = PllState(ly.from_lanes(cout[0]), ly.from_lanes(cout[1]),
                         ly.from_lanes(cout[2]), torch.cos(aw_last),
                         torch.sin(aw_last), nco_i[..., -1], nco_q[..., -1])
    return nco_i, nco_q, new_state


def pll_block_kernel(x: torch.Tensor, state: PllState, params: PllParams
                     ) -> tuple[torch.Tensor, torch.Tensor, PllState]:
    """Drop-in for ``ops.pll.pll_block`` (one PLL) on K2."""
    st1 = PllState(*[leaf[..., None] for leaf in state])
    i1, q1, st1 = pll_block_fused_kernel(x[..., None, :], st1, (params,))
    return (i1[..., 0, :], q1[..., 0, :],
            PllState(*[leaf[..., 0] for leaf in st1]))


def pll_mixer_fused_kernel(x: torch.Tensor, mix: torch.Tensor,
                           state: PllState, params_seq: Sequence[PllParams]
                           ) -> tuple[torch.Tensor, PllState]:
    """PLL recurrence + NCO cos + mixer product on K3.

    ``x``: (..., K, N) PLL inputs, ``mix``: (..., K, N) mixer operands.
    Returns ``(mixer, new_state)`` with ``mixer[..., k, :] ==
    nco_k[..., :-1] * mix[..., k, :] * 2``, as the unfused path computes
    it.  ``new_state`` keeps the full ``PllState`` contract; ``nco_q_last``
    is the sin of the last angle, computed here from the carried angle."""
    if mix.shape != x.shape:
        raise ValueError(f"mix {tuple(mix.shape)} != x {tuple(x.shape)}")
    ly = LaneLayout(x, params_seq)
    mixer_t, cout = pll_mixer(ly.time_major(x), ly.time_major(mix),
                              ly.carry0(state, True), ly.consts(True))
    aw_last = ly.from_lanes(cout[3])
    last_arg = ly.from_lanes(cout[5])
    new_state = PllState(
        ly.from_lanes(cout[0]), ly.from_lanes(cout[1]),
        ly.from_lanes(cout[2]), torch.cos(aw_last), torch.sin(aw_last),
        ly.from_lanes(cout[4]),
        torch.sin(last_arg * ly.from_lanes(ly.c["scale"])
                  + ly.from_lanes(ly.c["adj"])))
    return ly.from_time_major(mixer_t), new_state
