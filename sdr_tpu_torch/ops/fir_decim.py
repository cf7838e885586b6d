"""Batched decimating FIR over float input: kernel K5 and its plain version.

Port of ``sdr_tpu/ops/pallas_fir.py::fir_block_decim_pallas`` (the kernel
``fir_decim_pallas``).  Contract: ``x`` (..., N) float32, taps ``h`` (K,),
overlap-save ``state`` (..., K-1); returns ``(y (..., N/D), new_state
(..., K-1))`` with ``y[j] = sum_n h[n] * xc[K-1 + j*D - n]``, ``xc = [state,
x]``, and ``N % D == 0``.

On a CUDA tensor :func:`fir_block_decim` launches the hand-written kernel
``csrc/fir_decim.cu``; on a CPU tensor it runs :func:`fir_block_decim_plain`
(the banded-matmul FIR of ``ops.fir``).  The kernel reads ``x`` through its
strides: the time axis may have any element step (the receiver hands it
the (..., 2, N) view of interleaved I/Q, step 2, with no deinterleaved
copy) as long as the leading dims but the last collapse into one.

The same kernel template over int8 input is K4
(``ops.fir_frontend.fir_frontend_u8_deinterleaved``), launched through
:func:`launch`.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops import fir

_ENTRY = {torch.float32: "sdr_fir_decim_f32", torch.int8: "sdr_fir_decim_i8"}


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


def launch(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
           decim: int) -> torch.Tensor:
    """Launch the ``fir_decim.cu`` instance for ``x.dtype`` (float32: K5;
    int8 scaled by 2^-7: K4) on CUDA tensors; returns ``y``.  Raises on
    what the kernel does not take.  Counts nothing: each public wrapper
    counts its own launches."""
    if x.dtype not in _ENTRY or state.dtype != x.dtype:
        raise TypeError(f"x and state must both be float32 or int8, got "
                        f"{x.dtype} and {state.dtype}")
    if h.dtype != torch.float32 or h.ndim != 1 or not h.is_contiguous():
        raise ValueError("taps must be a contiguous 1-D float32 tensor")
    k, n = h.shape[0], x.shape[-1]
    if tuple(state.shape) != tuple(x.shape[:-1]) + (k - 1,):
        raise ValueError(f"state {tuple(state.shape)} must be "
                         f"{tuple(x.shape[:-1]) + (k - 1,)}")
    if n == 0 or n % decim:
        raise ValueError(f"block of {n} samples is not a positive multiple "
                         f"of the decimation {decim}")
    if not (x.device == h.device == state.device and x.is_cuda):
        raise ValueError("x, taps and state must be on one CUDA device")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    # rows of x as (outer, arm): view() raises if the dims before the last
    # two do not collapse into one stride
    x3 = x.view((-1,) + tuple(x.shape[-2:])) if x.ndim >= 2 else x.view(
        1, 1, n)
    batch = x3.shape[0] * x3.shape[1]
    y = torch.empty(tuple(x.shape[:-1]) + (n // decim,), dtype=torch.float32,
                    device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRY[x.dtype])(
            x3.data_ptr(), state.data_ptr(), h.data_ptr(), y.data_ptr(),
            batch, x3.shape[1], x3.stride(0), x3.stride(1), x3.stride(2), n,
            k, decim, torch.cuda.current_stream().cuda_stream)
    build.check(rc, _ENTRY[x.dtype])
    return y


def fir_block_decim(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
                    decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: the decimating FIR of float input (see the module docstring).

    A CUDA tensor launches the kernel and a CPU tensor takes the plain
    version; any other device raises."""
    if x.device.type == "cpu":
        return fir_block_decim_plain(x, h, state, decim)
    if x.device.type != "cuda":
        raise RuntimeError(f"no K5 kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"K5 takes float32 input, got {x.dtype}")
    y = launch(x, h, state, decim)
    fir_block_decim.launches += 1
    return y, tail(x, state)


fir_block_decim.launches = 0
