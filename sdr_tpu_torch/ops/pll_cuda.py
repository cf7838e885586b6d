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
* :func:`chain_floor` runs the kernels' feedback chain alone, with no
  memory traffic per step: its time is the serial floor of K2 and K3.

Layout (:class:`LaneLayout`): lanes are (batch x PLL arm), flattened as
``b*K + k``, and time is the leading axis of what the kernels read and
write.  The kernels stage rows of lanes into shared memory with 16-byte
bulk copies, so their time-major operands have rows ``lane_stride(L)``
floats apart (the lane count rounded up to a multiple of 4): ``LaneLayout``
builds them so, and the wrappers copy any other operand into that layout.
Per-lane constants are computed in float64 on the host and rounded once,
as the JAX package does; the constants also carry the turn breakpoints of
:func:`turn_breakpoints`, with which the kernels count turns without a
division.

On a CUDA tensor :func:`pll_angles` and :func:`pll_mixer` launch the
kernels of ``csrc/pll.cu``; on a CPU tensor they run
:func:`pll_angles_plain` / :func:`pll_mixer_plain`, the same recurrence in
plain PyTorch (``ops.pll.pll_args_loop``).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops.pll import (PllParams, PllState, loop_constants,
                                   pll_args_loop)

_F32 = torch.float32

#: rows of the carry, and of the constants (the last four are the turn
#: breakpoints), of K2 and of K3
K2_ROWS, K2_CONST_ROWS = 4, 8
K3_ROWS, K3_CONST_ROWS = 6, 10


# --- exact turn count ------------------------------------------------------


@functools.lru_cache(maxsize=1)
def turn_breakpoints() -> np.ndarray:
    """(4,) float32: b_k, the least float ``a >= 0`` with
    ``floor(fl(fl(a / 2pi) + 0.5)) >= k`` for k = 1..4, in float32
    arithmetic (numpy's division and addition round correctly, as the
    card's do).  The turn count is non-decreasing in ``a``, so for ``a``
    in [0, 8 pi] it equals the number of breakpoints ``<= a``: the
    kernels' replacement for the division and ``floor`` of the wrapped
    angle ``aw = arg - 2pi * turns(arg)``."""
    two_pi = np.float32(2.0 * math.pi)
    half = np.float32(0.5)

    def turns(bits: int) -> float:
        a = np.array([bits], np.uint32).view(np.float32)[0]
        return float(np.floor(np.float32(a / two_pi) + half))

    out = []
    for k in range(1, 5):
        lo = 0                                                  # turns 0
        hi = int(np.float32((k + 1) * 2.0 * math.pi).view(np.uint32))
        while hi - lo > 1:      # non-negative floats order as their bits
            mid = (lo + hi) // 2
            if turns(mid) >= k:
                hi = mid
            else:
                lo = mid
        out.append(hi)
    return np.array(out, np.uint32).view(np.float32)


# --- plain versions --------------------------------------------------------


def pll_angles_plain(xs: torch.Tensor, carry0: torch.Tensor,
                     consts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: xs (N, L), carry0 (4, L), consts (8, L) ->
    (args (N, L), carry (4, L)).  Carry rows: integrator, phase estimate,
    oscillator phase, last angle wrapped to [-pi, pi).  Const rows: kp, ki,
    w, modulus, then the turn breakpoints (which only the kernel reads)."""
    args, carry = pll_args_loop(xs, *carry0[:4], *consts[:4])
    return args, torch.stack(carry)


def pll_mixer_plain(xs: torch.Tensor, mix: torch.Tensor,
                    carry0: torch.Tensor, consts: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: xs, mix (N, L), carry0 (6, L), consts (10, L)
    -> (mixer (N, L), carry (6, L)).  Rows 4-5 of the carry are the
    previous NCO value and the last angle; rows 4-5 of the constants are
    the NCO scale and phase adjust, rows 6-9 the turn breakpoints.
    ``mixer[t] = nco[t-1] * mix[t] * 2`` with ``nco[-1]`` the carried
    previous NCO."""
    args, carry = pll_args_loop(xs, *carry0[:4], *consts[:4])
    nco = torch.cos(args * consts[4] + consts[5])
    shifted = torch.cat([carry0[4][None], nco[:-1]], dim=0)
    mixer = shifted * mix * 2.0
    return mixer, torch.stack([*carry, nco[-1], args[-1]])


def floor_signs(n: int, lanes: int) -> np.ndarray:
    """(n, lanes) float32: the +-1 input pattern that :func:`chain_floor`
    makes in registers (one linear congruential generator per lane)."""
    s = (np.uint32(0x9E3779B9)
         * np.arange(1, lanes + 1, dtype=np.uint32)).astype(np.uint32)
    out = np.empty((n, lanes), np.float32)
    with np.errstate(over="ignore"):
        for t in range(n):
            s = s * np.uint32(1664525) + np.uint32(1013904223)
            out[t] = np.where(s & np.uint32(0x80000000), -1.0, 1.0)
    return out


def chain_floor_plain(carry0: torch.Tensor, consts: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain version of the chain floor: the carry (4, L) after K2's
    recurrence over ``n`` steps of :func:`floor_signs`."""
    xs = torch.from_numpy(floor_signs(n, carry0.shape[1])).to(carry0.device)
    return pll_angles_plain(xs, carry0, consts)[1]


# --- kernel wrappers -------------------------------------------------------


def lane_stride(lanes: int) -> int:
    """Row stride, in floats, of the kernels' time-major operands: the lane
    count rounded up to a multiple of 4, so each row starts on a 16-byte
    boundary."""
    return -(-lanes // 4) * 4


def _kernel_rows(a: torch.Tensor) -> torch.Tensor:
    """(N, L) ``a`` as the kernels read it: unit lane stride, rows
    ``lane_stride(L)`` floats apart, a 16-byte-aligned base and the whole
    last row in memory.  ``a`` itself when it is so laid out, else a
    zero-padded copy (returned as its (N, L) view)."""
    n, lanes = a.shape
    ld = lane_stride(lanes)
    if (a.stride(1) == 1 and (a.stride(0) == ld or n == 1)
            and a.data_ptr() % 16 == 0
            and a.untyped_storage().nbytes()
            >= (a.storage_offset() + n * ld) * a.element_size()):
        return a
    buf = a.new_zeros((n, ld))
    buf[:, :lanes] = a
    return buf[:, :lanes]


def _check(carry_rows: int, const_rows: int, xs: torch.Tensor,
           carry0: torch.Tensor, consts: torch.Tensor,
           mix: torch.Tensor | None = None) -> None:
    ops = [xs, carry0, consts] + ([mix] if mix is not None else [])
    for t in ops:
        if t.dtype != _F32:
            raise TypeError(f"PLL kernel operands must be float32, got "
                            f"{t.dtype}")
        if t.device != xs.device:
            raise ValueError("PLL kernel operands must be on one device")
    if not (carry0.is_contiguous() and consts.is_contiguous()):
        raise ValueError("PLL carry and constants must be contiguous")
    if xs.ndim != 2 or xs.numel() == 0:
        raise ValueError(f"xs must be a non-empty (N, lanes) block, got "
                         f"{tuple(xs.shape)}")
    lanes = xs.shape[1]
    if tuple(carry0.shape) != (carry_rows, lanes) or \
            tuple(consts.shape) != (const_rows, lanes):
        raise ValueError(f"carry {tuple(carry0.shape)} and constants "
                         f"{tuple(consts.shape)} must be "
                         f"{(carry_rows, lanes)} and {(const_rows, lanes)}")
    if mix is not None and mix.shape != xs.shape:
        raise ValueError(f"mix {tuple(mix.shape)} != xs {tuple(xs.shape)}")


def _device_kind(xs: torch.Tensor, name: str) -> str:
    """'cpu' or 'cuda'; any other device raises."""
    if xs.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no {name} kernel for device {xs.device}")
    return xs.device.type


def pll_angles(xs: torch.Tensor, carry0: torch.Tensor, consts: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: the recurrence's angles (contract of :func:`pll_angles_plain`).
    A CUDA tensor launches the kernel and a CPU tensor takes the plain
    version; any other device raises.  On the card the angles come back as
    an (N, L) view of a (N, lane_stride(L)) buffer."""
    kind = _device_kind(xs, "K2")
    _check(K2_ROWS, K2_CONST_ROWS, xs, carry0, consts)
    if kind == "cpu":
        return pll_angles_plain(xs, carry0, consts)
    xs = _kernel_rows(xs)
    n, lanes = xs.shape
    ld = lane_stride(lanes)
    args = torch.empty((n, ld), dtype=_F32, device=xs.device)
    carry = torch.empty_like(carry0)
    lib = build.load()
    with torch.cuda.device(xs.device):
        rc = lib.sdr_pll_angles(
            xs.data_ptr(), carry0.data_ptr(), consts.data_ptr(),
            args.data_ptr(), carry.data_ptr(), n, lanes, ld,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pll_angles")
    pll_angles.launches += 1
    return args[:, :lanes], carry


pll_angles.launches = 0


def pll_mixer(xs: torch.Tensor, mix: torch.Tensor, carry0: torch.Tensor,
              consts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: recurrence + NCO cos + mixer (contract of
    :func:`pll_mixer_plain`).  A CUDA tensor launches the kernel and a CPU
    tensor takes the plain version; any other device raises.  On the card
    the products come back as an (N, L) view of a (N, lane_stride(L))
    buffer."""
    kind = _device_kind(xs, "K3")
    _check(K3_ROWS, K3_CONST_ROWS, xs, carry0, consts, mix)
    if kind == "cpu":
        return pll_mixer_plain(xs, mix, carry0, consts)
    xs, mix = _kernel_rows(xs), _kernel_rows(mix)
    n, lanes = xs.shape
    ld = lane_stride(lanes)
    mixer = torch.empty((n, ld), dtype=_F32, device=xs.device)
    carry = torch.empty_like(carry0)
    lib = build.load()
    with torch.cuda.device(xs.device):
        rc = lib.sdr_pll_mixer(
            xs.data_ptr(), mix.data_ptr(), carry0.data_ptr(),
            consts.data_ptr(), mixer.data_ptr(), carry.data_ptr(), n, lanes,
            ld, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pll_mixer")
    pll_mixer.launches += 1
    return mixer[:, :lanes], carry


pll_mixer.launches = 0


def chain_floor(carry0: torch.Tensor, consts: torch.Tensor,
                n: int) -> torch.Tensor:
    """The feedback chain of K2/K3 alone on the card: one warp, ``n`` steps
    on the :func:`floor_signs` pattern made in registers, for at most 32
    lanes; returns the carry (4, L) (contract of :func:`chain_floor_plain`).
    Its time over ``n`` is the serial floor of the PLL kernels.  Card
    only: a CPU tensor takes the plain version."""
    kind = _device_kind(carry0, "chain floor")
    lanes = carry0.shape[1]
    if tuple(consts.shape) != (K2_CONST_ROWS, lanes) or lanes > 32 \
            or carry0.shape[0] != K2_ROWS or n < 1:
        raise ValueError(f"chain floor takes carry (4, L <= 32), constants "
                         f"(8, L) and n >= 1, got {tuple(carry0.shape)}, "
                         f"{tuple(consts.shape)}, {n}")
    if kind == "cpu":
        return chain_floor_plain(carry0, consts, n)
    carry = torch.empty_like(carry0)
    lib = build.load()
    with torch.cuda.device(carry0.device):
        rc = lib.sdr_pll_chain_floor(
            carry0.data_ptr(), consts.data_ptr(), carry.data_ptr(), n, lanes,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pll_chain_floor")
    chain_floor.launches += 1
    return carry


chain_floor.launches = 0


# --- drop-ins for ops.pll --------------------------------------------------


# The kernels' constants are made once per (params, batch, device) and kept
# on the device for the life of the process: a block uploads nothing from
# the host, and a captured block program (models.program) reads them by
# address, so no cache entry may ever be freed.  Shared: never written.


@functools.cache
def lane_constants(params_seq: tuple[PllParams, ...], nl: int,
                   device: torch.device) -> dict[str, torch.Tensor]:
    """The (K,) loop constants of ``ops.pll.loop_constants`` repeated over
    a batch of ``nl``: (L,) per lane, lanes ``b*K + k``."""
    return {name: v.repeat(nl) for name, v in
            loop_constants(params_seq, _F32, device).items()}


@functools.cache
def breakpoints_on(device: torch.device) -> torch.Tensor:
    """:func:`turn_breakpoints` as a (4,) float32 tensor on ``device``."""
    return torch.from_numpy(turn_breakpoints()).to(device)


@functools.cache
def kernel_constants(params_seq: tuple[PllParams, ...], nl: int,
                     mixer: bool, device: torch.device) -> torch.Tensor:
    """(8, L) constants of K2, or (10, L) of K3: the loop constants (kp,
    ki, w, modulus; K3 also the NCO scale and phase adjust), then the four
    turn breakpoints, each repeated over the L lanes."""
    c = lane_constants(params_seq, nl, device)
    rows = LaneLayout._CONST_ROWS if mixer else LaneLayout._CONST_ROWS[:4]
    total = c["kp"].shape[0]
    return torch.cat([torch.stack([c[r] for r in rows]),
                      breakpoints_on(device)[:, None].expand(4, total)])


class LaneLayout:
    """The kernels' operands for one call: lanes are (batch x arm),
    flattened as ``b*K + k``, and time is the leading axis, with rows
    ``lane_stride(L)`` floats apart."""

    _CONST_ROWS = ("kp", "ki", "w", "m", "scale", "adj")

    def __init__(self, x: torch.Tensor, params_seq: Sequence[PllParams]):
        self.k = len(params_seq)
        if x.shape[-2] != self.k:
            raise ValueError(f"x has {x.shape[-2]} arms, params_seq {self.k}")
        self.n = x.shape[-1]
        self.lead = x.shape[:-2]
        self.nl = math.prod(self.lead)
        self.total = self.nl * self.k
        self.device = x.device
        self.params = tuple(params_seq)
        # (K,) per-arm constants repeated over the batch -> (L,)
        self.c = lane_constants(self.params, self.nl, x.device)

    def time_major(self, a: torch.Tensor) -> torch.Tensor:
        """(..., K, N) -> (N, L) float32, as an (N, L) view of a
        zero-padded (N, lane_stride(L)) buffer."""
        ld = lane_stride(self.total)
        buf = torch.zeros((self.n, ld), dtype=_F32, device=a.device) \
            if ld != self.total else \
            torch.empty((self.n, ld), dtype=_F32, device=a.device)
        buf[:, :self.total] = a.reshape(self.total, self.n).t()
        return buf[:, :self.total]

    def from_time_major(self, a: torch.Tensor) -> torch.Tensor:
        """(N, L) -> (..., K, N)."""
        return a.t().reshape(self.lead + (self.k, self.n))

    def from_lanes(self, a: torch.Tensor) -> torch.Tensor:
        """(L,) -> (..., K)."""
        return a.reshape(self.lead + (self.k,))

    def consts(self, mixer: bool) -> torch.Tensor:
        """(8, L) constants of K2, or (10, L) of K3: the loop constants,
        then the four turn breakpoints (:func:`kernel_constants`)."""
        return kernel_constants(self.params, self.nl, mixer, self.device)

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
