"""Batched decimating FIR: kernel K5 (float input), the template it shares
with K1 and K4, and its plain version.

Port of ``sdr_tpu/ops/pallas_fir.py::fir_block_decim_pallas`` (the kernel
``fir_decim_pallas``).  Contract: ``x`` (..., N) float32, taps ``h`` (K,),
overlap-save ``state`` (..., K-1); returns ``(y (..., N/D), new_state
(..., K-1))`` with ``y[j] = sum_n h[n] * xc[K-1 + j*D - n]``, ``xc = [state,
x]``, ``N % D == 0``, and ``new_state`` the last K-1 samples of ``xc``.

On a CUDA tensor :func:`fir_block_decim` launches the hand-written kernel
``csrc/fir_decim.cu``, which writes ``y`` and ``new_state`` in one launch;
on a CPU tensor it runs :func:`fir_block_decim_plain` (the banded-matmul
FIR of ``ops.fir``).  The kernel reads ``x`` in place through its strides:
a contiguous time axis, or the (..., 2, N) view of interleaved I/Q (element
step 2, the receiver's front-end, staged once for both arms); any other
layout is copied to contiguous first.  Its geometry is :func:`plan`, a
pure function of the shape.

The same template takes one-byte input through :func:`launch`: raw u8
I/Q (K1, ``ops.fir_frontend.fir_frontend_u8``) and bias-flipped int8 (K4,
``ops.fir_frontend.fir_frontend_u8_deinterleaved``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops import fir

SMS = 132                      # the H100 SXM's SMs, for plans made off the card
MAX_SHARED = 232_448           # shared bytes a block may use
SM_SHARED = 233_472            # shared bytes of an SM (1 KB kept per block)
TAPS_STEP = 4                  # taps per phase, a multiple (csrc kT)
BAR_BYTES = 64                 # the mbarriers at the start of shared memory
MAX_WARPS = 4                  # compute warps per block


class FirPlan(NamedTuple):
    """The launch geometry of the FIR template for one shape (:func:`plan`).

    A work item is (span, tile): ``tile`` consecutive outputs of each of a
    span's ``lanes`` interleaved arms.  A block runs one producer warp and
    ``warps`` compute warps; compute warp w takes arm ``w % lanes`` and
    outputs ``(w // lanes) * 32 * r`` .. + ``32 * r`` of the item, ``r``
    per lane.  Blocks walk items ``block, block + grid, ...``."""

    spans: int
    lanes: int
    n_out: int
    r: int              # consecutive outputs per thread: 8, or 1 when small
    warps: int          # compute warps per block
    tile: int           # outputs per arm and work item
    n_tiles: int        # work items per span
    r_pad: int          # taps per phase, ceil(K/D) rounded up to TAPS_STEP
    spw: int            # floats per phase row of a warp's split buffer:
    #                     its 32 * r + r_pad window rows rounded up to 8
    #                     (the swizzle permutes aligned groups of 8), then
    #                     padded for the banks
    raw: int            # bytes per stage of the staged span
    stages: int         # stages of the ring
    smem: int           # dynamic shared bytes per block
    grid: int           # persistent blocks

    @property
    def items(self) -> int:
        return self.spans * self.n_tiles

    def item_outputs(self, item: int) -> list[tuple[int, int, int, tuple]]:
        """(output row, first output, count, order) of every warp and lane
        of work item ``item``, as the kernel assigns them; lanes past the
        end of a row compute nothing.  ``order`` is what decides the
        summation order of those outputs: by phase, then by each of the
        phase's ``r_pad`` taps, whatever the lane, warp, item or R."""
        out = []
        span, j0 = divmod(item, self.n_tiles)
        j0 *= self.tile
        j1 = min(j0 + self.tile, self.n_out)
        for w in range(self.warps):
            arm, chunk = w % self.lanes, w // self.lanes
            for lane in range(32):
                j = j0 + chunk * 32 * self.r + lane * self.r
                if j < j1:
                    out.append((span * self.lanes + arm, j,
                                min(self.r, j1 - j),
                                ("by phase, then tap", self.r_pad)))
        return out

    def outputs(self, block: int) -> list[tuple[int, int, int, tuple]]:
        """:meth:`item_outputs` of every item of ``block``, in the order the
        block walks them."""
        return [o for item in range(block, self.items, self.grid)
                for o in self.item_outputs(item)]


def _shared_bytes(decim: int, r_pad: int, raw: int, stages: int, warps: int,
                  spw: int) -> int:
    return BAR_BYTES + 4 * (decim * r_pad + warps * decim * spw) + stages * raw


def blocks_per_sm(p: FirPlan) -> int:
    """Blocks of plan ``p`` that fit on one SM at once (shared memory,
    threads)."""
    return max(1, min(SM_SHARED // (p.smem + 1024),
                      2048 // (32 * (p.warps + 1)), 32))


def plan(spans: int, lanes: int, n: int, k: int, decim: int,
         sms: int = SMS, elem: int = 4) -> FirPlan:
    """The template's geometry for ``spans`` staged rows of ``lanes``
    interleaved arms of ``n`` samples of ``elem`` bytes (4 float, 1 u8 or
    int8), ``k`` taps, decimation ``decim``, on a card of ``sms`` SMs.

    R = 8 outputs per thread and four compute warps (two for interleaved
    I/Q, one per arm, whose spans are twice as long), each 256 outputs of
    an arm; when that gives fewer items than SMs, R = 1 and one warp per
    arm, 32 outputs per item, so that a small block still spreads over the
    card.  One to three stages, whichever lets the most blocks share an
    SM.  The grid is as many blocks as fit on the card, at most one per
    item."""
    if lanes not in (1, 2) or spans < 1 or n < 1 or k < 2 or decim < 1 \
            or n % decim or elem not in (1, 4):
        raise ValueError(f"no FIR plan for spans {spans}, lanes {lanes}, n "
                         f"{n}, k {k}, decim {decim}, elem {elem}")
    n_out = n // decim
    r_pad = -(-(-(-k // decim)) // TAPS_STEP) * TAPS_STEP
    # phase rows of a warp's split: a row offset of 4 * ceil(8/D) words
    # mod 32 spreads the phases of one staged word run over the banks
    row_pad = (4 * -(-8 // decim)) % 32

    def shape(r: int, chunks: int, stages: int) -> FirPlan:
        warps = chunks * lanes
        tile = chunks * 32 * r
        n_tiles = -(-n_out // tile)
        rows_m = -(-(32 * r + r_pad) // 8) * 8
        spw = rows_m + (row_pad - rows_m) % 32
        raw = -(-((tile + r_pad) * decim * lanes * elem + 32) // 16) * 16
        smem = _shared_bytes(decim, r_pad, raw, stages, warps, spw)
        p = FirPlan(spans, lanes, n_out, r, warps, tile, n_tiles, r_pad,
                    spw, raw, stages, smem, 0)
        return p._replace(grid=min(p.items, blocks_per_sm(p) * sms))

    r, chunks = 8, (MAX_WARPS if lanes == 1 else 1)
    if spans * -(-n_out // (chunks * 32 * r)) < sms:
        r, chunks = 1, 1
    # of the ring depths that fit, the one that lets the most blocks share
    # an SM, the deeper on a tie: at the paths' large shapes one stage and
    # more resident blocks ran faster than two or three (PERF.md)
    shapes = [shape(r, chunks, st) for st in (3, 2, 1)]
    fits = [q for q in shapes if q.smem <= MAX_SHARED]
    if not fits:
        raise ValueError(f"the FIR needs {shapes[-1].smem} shared bytes for "
                         f"k {k}, decim {decim}: more than {MAX_SHARED}")
    return max(fits, key=lambda q: (blocks_per_sm(q), q.stages))


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fir_block_decim_plain(x: torch.Tensor, h: torch.Tensor,
                          state: torch.Tensor, decim: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: the fp32 banded-matmul decimating FIR
    (``ops.fir.fir_block_decim_mm``).  Runs on any device."""
    return fir.fir_block_decim_mm(x, h, state, decim)


def tail(x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The last K-1 samples of ``[state, x]``, also for a block shorter than
    K-1 (it then keeps part of the state)."""
    take = min(x.shape[-1], state.shape[-1])
    return torch.cat([state[..., take:], x[..., x.shape[-1] - take:]],
                     dim=-1)


def _check(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
           decim: int) -> None:
    """What the FIR kernels need of their operands; raises otherwise."""
    if h.dtype != torch.float32 or h.ndim != 1 or not h.is_contiguous():
        raise ValueError("taps must be a contiguous 1-D float32 tensor")
    n = x.shape[-1]
    if state.shape[:-1] != x.shape[:-1] or state.shape[-1] != h.shape[0] - 1:
        raise ValueError(f"state {tuple(state.shape)} must be "
                         f"{tuple(x.shape[:-1]) + (h.shape[0] - 1,)}")
    if n == 0 or n % decim:
        raise ValueError(f"block of {n} samples is not a positive multiple "
                         f"of the decimation {decim}")
    if not x.get_device() == h.get_device() == state.get_device():
        raise ValueError("x, taps and state must be on one device")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")


def _spans(x: torch.Tensor) -> tuple[int, int, int, int, int]:
    """How the kernel reads ``x`` in place: (spans, lanes, spans per outer row,
    outer stride, arm stride), or spans 0 when it must be copied to
    contiguous first.  Integer arithmetic on shape and strides, no view."""
    shape, st = x.shape, x.stride()
    if x.ndim == 1:
        return (1, 1, 1, 0, 0) if st[0] == 1 else (0, 0, 0, 0, 0)
    arms, step = shape[-2], st[-1]
    outer = 1
    for i in range(x.ndim - 3, -1, -1):      # the dims before the last two
        if shape[i] != 1 and st[i] != st[-3] * outer:
            return 0, 0, 0, 0, 0
        outer *= shape[i]
    os_ = st[-3] if x.ndim > 2 else 0
    if step == 1:
        return outer * arms, 1, arms, os_, st[-2]
    if arms == 2 and step == 2 and st[-2] == 1:
        return outer, 2, 1, os_, 0                  # interleaved I/Q
    return 0, 0, 0, 0, 0


#: the input kinds of the template (csrc: 0 float, 1 u8, 2 int8) and the
#: state type each takes
_KINDS = {torch.float32: (0, torch.float32), torch.uint8: (1, torch.float32),
          torch.int8: (2, torch.int8)}



class _Recipe(NamedTuple):
    """What one layout of the operands needs per call, worked out once."""

    copy: bool                  # x must be made contiguous first
    geometry: ctypes.Array      # the kernel's 20 integers (csrc)
    y_shape: tuple


# layout key (types, shapes, strides, decimation, devices) -> _Recipe.
# A recipe is read on the host at launch only (the kernel takes its
# geometry by value), so a captured block program (models.program) does not
# depend on the entry staying; its first use for a layout, in the program's
# eager warm-up, also queries the card's SM count (_sms) outside the capture.
_recipes: dict[tuple, _Recipe] = {}


def _recipe(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
            decim: int, view) -> _Recipe:
    if view is not None:
        v = view(x, h, state, decim)
        copy = v.data_ptr() != x.data_ptr() or not _spans(v)[0]
        x = v.contiguous() if copy else v
    else:
        copy = not _spans(x)[0]
        if copy:
            x = x.contiguous()
    _check(x, h, state, decim)
    if x.dtype not in _KINDS:
        raise TypeError(f"the FIR kernel takes float32, uint8 or int8 input, "
                        f"got {x.dtype}")
    kind, state_dtype = _KINDS[x.dtype]
    if state.dtype != state_dtype:
        raise TypeError(f"{x.dtype} input takes a {state_dtype} state, got "
                        f"{state.dtype}")
    spans, lanes, spo, os_, as_ = _spans(x)
    k, n = h.shape[0], x.shape[-1]
    device = x.get_device()
    p = plan(spans, lanes, n, k, decim, _sms(device), x.element_size())
    geometry = (ctypes.c_longlong * 20)(device, kind, spans, lanes, spo, n, k,
                                        decim, os_, as_, *p[3:])
    return _Recipe(copy, geometry, tuple(x.shape[:-1]) + (n // decim,))


def launch(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
           decim: int, view=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the FIR template on CUDA tensors: float32 input with a float32
    state (K5), uint8 with a float32 u8-normalized state (K1: x - 128
    times 2^-7), int8 with an int8 state (K4: times 2^-7).  Returns ``(y,
    new_state)``, both float32.  Raises on what the kernel does not take.
    Counts nothing: the public wrappers count.

    ``view(x, h, state, decim)``, when given, checks the operands and
    returns the tensor the kernel reads (K1: the (..., 2, N) view of the
    interleaved bytes).  It runs when a layout (types, shapes, strides,
    devices) is new, as do the checks and the launch plan
    (:func:`_recipe`); a known layout only allocates and launches."""
    device = x.get_device()
    key = (x.dtype, x.shape, x.stride(), state.dtype, state.shape,
           state.stride(), h.dtype, h.shape, h.stride(), decim, device,
           state.get_device(), h.get_device(), view)
    rec = _recipes.get(key)
    if rec is None:
        if len(_recipes) >= 256:
            _recipes.clear()
        rec = _recipes[key] = _recipe(x, h, state, decim, view)
    if rec.copy:
        x = (x if view is None else view(x, h, state, decim)).contiguous()
    y = torch.empty(rec.y_shape, dtype=torch.float32, device=x.device)
    new_state = torch.empty(state.shape, dtype=torch.float32,
                            device=x.device)
    rc = build.load().sdr_fir_decim(
        x.data_ptr(), state.data_ptr(), h.data_ptr(), y.data_ptr(),
        new_state.data_ptr(), rec.geometry, build.current_stream(device))
    build.check(rc, "sdr_fir_decim")
    return y, new_state


def fir_block_decim(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
                    decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: the decimating FIR of float input (see the module docstring).

    A CUDA tensor launches the kernel and a CPU tensor takes the plain
    version; any other device raises."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fir_block_decim_plain(x, h, state, decim)
        raise RuntimeError(f"no K5 kernel for device {x.device}")
    if x.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"K5 takes float32 input and state, got {x.dtype} "
                        f"and {state.dtype}")
    out = launch(x, h, state, decim)
    fir_block_decim.launches += 1
    return out


fir_block_decim.launches = 0
