"""RF front-end on raw u8 I/Q: kernels K1 and K4 and their plain version.

K1 is the port of ``sdr_tpu/ops/pallas_fir_mxu.py::
fir_frontend_u8_pallas_int``, the receiver's u8 front-end.  K4
(:func:`fir_frontend_u8_deinterleaved`, the port of
``fir_frontend_u8_pallas``) computes the same function in the JAX
package's deinterleaved int8 form; no path of either package runs it by
default.  Both are instances of the FIR template ``csrc/fir_decim.cu``
that K5 also runs (``ops.fir_decim.launch``).

Contract (both): interleaved uint8 ``(..., 2N)`` in, taps ``h`` (K,) and the
stacked I/Q overlap-save state ``(..., 2, K-1)`` (f32, u8-normalized), out
``((..., 2, N/D) f32, (..., 2, K-1) f32 new state)``.

On a CUDA tensor :func:`fir_frontend_u8` launches the template on the raw
bytes, which it stages as bytes and normalizes exactly in shared memory,
so the deinterleaved, normalized signal never reaches device memory; the
same launch writes the new state.  On a CPU tensor it runs
:func:`fir_frontend_u8_plain`, the same function in plain PyTorch.

The kernel reads the carried state as f32 directly (the TPU kernel turns
it back into bytes, which is exact only for a u8-normalized state), and the
new state is the exact normalized tail of ``[state, block]``.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.ops import fir, fir_decim


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """(x - 128) / 128 as float32, exact for every byte."""
    return (x.to(torch.float32) - 128.0) * (1.0 / 128.0)


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., 2N) interleaved -> (..., 2, N)."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)).movedim(-1, -2)


def _check(iq_u8: torch.Tensor, h: torch.Tensor, st2: torch.Tensor,
           decim: int) -> None:
    if iq_u8.dtype != torch.uint8:
        raise TypeError(f"iq must be uint8, got {iq_u8.dtype}")
    if h.dtype != torch.float32 or st2.dtype != torch.float32:
        raise TypeError("taps and state must be float32")
    if h.ndim != 1:
        raise ValueError(f"taps must be 1-D, got shape {tuple(h.shape)}")
    want = iq_u8.shape[:-1] + (2, h.shape[0] - 1)
    if iq_u8.shape[-1] % 2 or tuple(st2.shape) != want:
        raise ValueError(f"iq {tuple(iq_u8.shape)} must be interleaved and "
                         f"state {tuple(st2.shape)} must be {want}")
    n = iq_u8.shape[-1] // 2
    if n == 0 or n % decim:
        raise ValueError(f"block of {n} samples is not a positive multiple "
                         f"of the decimation {decim}")


def _checked_view(iq_u8: torch.Tensor, h: torch.Tensor, st2: torch.Tensor,
                  decim: int) -> torch.Tensor:
    """What K1's kernel reads, once the operands are checked: the (..., 2,
    N) view of the interleaved bytes (element step 2).  The launch runs it
    once per layout."""
    _check(iq_u8, h, st2, decim)
    return _deinterleave(iq_u8)


def fir_frontend_u8_plain(iq_u8: torch.Tensor, h: torch.Tensor,
                          st2: torch.Tensor, decim: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: deinterleave, normalize, then the banded-matmul
    decimating FIR in fp32.  Runs on any device."""
    _check(iq_u8, h, st2, decim)
    x2 = normalize_u8(_deinterleave(iq_u8))
    return fir.fir_block_decim_mm(x2, h, st2, decim)


def fir_frontend_u8(iq_u8: torch.Tensor, h: torch.Tensor, st2: torch.Tensor,
                    decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the RF front-end FIR of raw u8 I/Q (see the module docstring).

    A CUDA tensor launches the u8 instance of the FIR template on the
    (..., 2, N) view of the interleaved bytes (made, and the operands
    checked, once per layout), one launch that also writes the new state;
    a CPU tensor takes the plain version; any other device raises."""
    if iq_u8.device.type == "cpu":
        return fir_frontend_u8_plain(iq_u8, h, st2, decim)
    if iq_u8.device.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {iq_u8.device}")
    out = fir_decim.launch(iq_u8, h, st2, decim, view=_checked_view)
    fir_frontend_u8.launches += 1
    return out


fir_frontend_u8.launches = 0


def fir_frontend_u8_deinterleaved(iq_u8: torch.Tensor, h: torch.Tensor,
                                  st2: torch.Tensor, decim: int
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: the same function as K1 in the JAX package's deinterleaved form.

    Port of ``sdr_tpu/ops/pallas_fir_mxu.py::fir_frontend_u8_pallas``.  As
    there, the bias flip ``u8 ^ 0x80`` (two's complement u8 - 128), the
    deinterleave and ``round(st2 * 128)`` of the state (exact for a
    u8-normalized state) run outside the kernel, here in PyTorch; then the
    int8 instance of the FIR template runs the FIR with the 2^-7 scale and
    writes the new f32 state.  A CPU tensor takes
    :func:`fir_frontend_u8_plain`, K1's plain version; any other device
    than CUDA raises."""
    if iq_u8.device.type == "cpu":
        return fir_frontend_u8_plain(iq_u8, h, st2, decim)
    if iq_u8.device.type != "cuda":
        raise RuntimeError(f"no K4 kernel for device {iq_u8.device}")
    _check(iq_u8, h, st2, decim)
    x2 = _deinterleave((iq_u8 ^ 0x80).view(torch.int8)).contiguous()
    st_i8 = torch.round(st2 * 128.0).to(torch.int8)
    out = fir_decim.launch(x2, h, st_i8, decim)
    fir_frontend_u8_deinterleaved.launches += 1
    return out


fir_frontend_u8_deinterleaved.launches = 0
