"""Streaming FIR filters as window gathers plus fp32 matrix products.

Port of the banded-matmul forms of ``sdr_tpu/ops/fir.py`` (the ``*_mm``
functions), which are the forms the receiver's main path runs.  Each block
of U consecutive outputs of a decimating FIR is one row of overlapped input
windows times a banded weight matrix:

    Y[..., w, u] = sum_t X[..., w, t] * W[t, u]
    X[..., w, t] = xc[..., w*U*D + t]          xc = [state, x]
    W[t, u]      = h[K-1 + u*D - t]            (zero outside the band)

with T_win = (U-1)*D + K.  The overlap-save state is the trailing K-1
samples of ``[state, x]``, so a block shorter than K-1 samples carries part
of the incoming state forward.  Every product runs in full fp32: the JAX
package runs these at ``Precision.HIGH`` (~1.5e-5 relative), and TF32
(~1e-3) would be too coarse, so the receiver turns TF32 off.

These were XLA, not Pallas, in the JAX package, so here they are plain
PyTorch on any device.  Every function takes leading batch dims.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# the natural-domain resampler state length, ceil(K/U) - 1, a name of the
# JAX package's ops.fir; one function with the port's golden filters'
from sdr_tpu_torch.golden.filters import resample_state_len  # noqa: F401


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# --- static index maps (numpy; copied from sdr_tpu.ops.fir, which imports
# jax) ---------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _resample_maps(n_in: int, n_taps: int, decim: int,
                   upsamp: int) -> tuple[np.ndarray, np.ndarray]:
    """(input-window index, coefficient-selector index) maps for the
    phase-gathered resampler.  Returns (xidx (n_out, T), nidx (n_out, T))
    where nidx entries >= n_taps mark taps beyond the filter (zero coeff)."""
    t = _cdiv(n_taps, upsamp)
    n_out = n_in * upsamp // decim
    j = np.arange(n_out)
    m = j * decim
    p = m % upsamp
    q = (m - p) // upsamp + (t - 1)
    r = np.arange(t)
    nidx = p[:, None] + r[None, :] * upsamp     # tap index (may exceed K-1)
    xidx = q[:, None] - r[None, :]              # index into xc
    return xidx, nidx


@functools.lru_cache(maxsize=64)
def _decim_band_maps(n_taps: int, decim: int,
                     u_blk: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(tap-index map, validity mask, T_win) for the banded decimating-FIR
    weight matrix W[t, u] = h[K-1 + u*D - t]."""
    t_win = (u_blk - 1) * decim + n_taps
    t = np.arange(t_win)[:, None]
    u = np.arange(u_blk)[None, :]
    n = n_taps - 1 + u * decim - t
    valid = (n >= 0) & (n < n_taps)
    return np.clip(n, 0, n_taps - 1), valid, t_win


@functools.lru_cache(maxsize=64)
def _resample_band_np(n_taps: int, decim: int,
                      upsamp: int) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray, int]:
    """Static scatter maps for the banded resampler weight matrix.

    Output block = one full phase cycle (U outputs), window stride D
    inputs: y[w*U + u] = sum_r h[p_u + r*U] * xc[w*D + c_u + (t-1) - r]
    with p_u = (u*D) mod U, c_u = (u*D - p_u)/U, t = ceil(K/U).
    Returns (o_idx (t, U), n_idx (t, U), valid (t, U), T_win)."""
    t = _cdiv(n_taps, upsamp)
    u = np.arange(upsamp)
    p = (u * decim) % upsamp
    c = (u * decim - p) // upsamp
    r = np.arange(t)[:, None]
    n_idx = p[None, :] + r * upsamp               # tap index
    o_idx = c[None, :] + (t - 1) - r              # window offset
    valid = n_idx < n_taps
    t_win = int(c.max()) + t
    return o_idx, np.clip(n_idx, 0, n_taps - 1), valid, t_win


@functools.cache
def _maps_on(make_maps, args: tuple, device: torch.device) -> tuple:
    """The numpy index maps of ``make_maps(*args)`` as tensors on
    ``device``, made once per shape and device so a streaming loop copies
    no index map per block.

    The first call for a shape copies the maps from the host, which a CUDA
    graph cannot capture: a block program (``models.program``) makes that
    call in its eager warm-up, before the capture.  The graph then reads
    the maps by address, so no entry is ever evicted (the cache is
    unbounded: a few entries per mode and block length)."""
    return tuple(torch.as_tensor(a, device=device) if isinstance(a, np.ndarray)
                 else a for a in make_maps(*args))


def _band_matrix(h: torch.Tensor, decim: int,
                 u_blk: int) -> tuple[torch.Tensor, int]:
    """Banded W (T_win, u_blk) from the taps ``h``."""
    nmap, valid, t_win = _maps_on(_decim_band_maps,
                                  (h.shape[0], decim, u_blk), h.device)
    return torch.where(valid, h[nmap], 0.0), t_win


def _multi_band_matrix(hs: torch.Tensor, u_blk: int
                       ) -> tuple[torch.Tensor, int]:
    """Banded W (T_win, C, u_blk) of the unit-stride filters ``hs`` (C,
    K), side by side."""
    nmap, valid, t_win = _maps_on(_decim_band_maps,
                                  (hs.shape[1], 1, u_blk), hs.device)
    # hs.T is (K, C); index taps with nmap (T_win, U) -> (T_win, U, C)
    w3 = torch.where(valid[..., None], hs.T[nmap], 0.0)
    return w3.movedim(-1, 1), t_win


def _resample_band_matrix(h: torch.Tensor, decim: int, upsamp: int
                          ) -> tuple[torch.Tensor, int]:
    """Banded W (T_win, upsamp) of the resampler, xU gain: one phase cycle
    of U outputs per window (:func:`_resample_band_np`)."""
    o_idx, n_idx, valid, t_win = _maps_on(_resample_band_np,
                                          (h.shape[0], decim, upsamp),
                                          h.device)
    vals = torch.where(valid, h[n_idx] * upsamp, 0.0)
    cols = torch.arange(upsamp, device=h.device).expand_as(o_idx)
    w = torch.zeros((t_win, upsamp), dtype=torch.float32, device=h.device)
    w.index_put_((o_idx, cols), vals, accumulate=True)
    return w, t_win


def _gather_windows(xc: torch.Tensor, n_win: int, stride: int,
                    t_win: int) -> torch.Tensor:
    """(..., L) -> (..., n_win, t_win) overlapped windows.

    Windows that run past the end read zeros (the JAX form clamps the
    index instead).  Such reads meet only zero weights or outputs that are
    cut off, so the kept outputs are the same either way."""
    need = (n_win - 1) * stride + t_win
    if need > xc.shape[-1]:
        xc = F.pad(xc, (0, need - xc.shape[-1]))
    return xc.unfold(-1, t_win, stride)[..., :n_win, :]


def pin_fp32_matmul() -> None:
    """Turn TF32 off for matrix products and convolutions.  The FIRs need
    full fp32: TF32 keeps ~1e-3 relative precision, where the JAX package's
    FIRs hold ~1.5e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_decim(n: int, decim: int) -> None:
    if n % decim:
        raise ValueError(f"block length {n} is not a multiple of the "
                         f"decimation {decim}")


# --- the streaming filters -----------------------------------------------


def fir_block_decim_mm(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
                       decim: int, u_blk: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming decimating FIR, y[j] = sum_n h[n] * xc[K-1 + j*D - n].

    Port of ``sdr_tpu.ops.fir.fir_block_decim_mm``; at ``decim=1`` it is the
    unit-stride FIR.  Returns (y (..., N/D), new_state (..., K-1))."""
    k = h.shape[0]
    n = x.shape[-1]
    _check_decim(n, decim)
    n_out = n // decim
    u_blk = min(u_blk, n_out)
    n_win = _cdiv(n_out, u_blk)
    xc = torch.cat([state, x], dim=-1)
    w, t_win = _band_matrix(h, decim, u_blk)
    xw = _gather_windows(xc, n_win, u_blk * decim, t_win)
    y = torch.matmul(xw, w)
    y = y.reshape(y.shape[:-2] + (n_win * u_blk,))[..., :n_out]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


def fir_block_decim(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
                    decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming decimating FIR with the contract of
    ``sdr_tpu.ops.fir.fir_block_decim``: y[j] = sum_n h[n] * xc[K-1 + j*D
    - n], xc = [state, x].  The JAX package computes it as a convolution;
    the port computes it in the banded form (:func:`fir_block_decim_mm`)."""
    return fir_block_decim_mm(x, h, state, decim)


def fir_block(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming FIR, unit stride (``sdr_tpu.ops.fir.fir_block``), in the
    banded form."""
    return fir_block_decim_mm(x, h, state, 1)


def fir_block_multi_mm(x: torch.Tensor, hs: torch.Tensor,
                       states: torch.Tensor, u_blk: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """C same-length filters over one input as a single (T_win x C*U)
    product.  ``hs`` is (C, K); ``states`` is the one shared (..., K-1)
    tail.  Returns ((..., C, N), new_state).  Port of
    ``sdr_tpu.ops.fir.fir_block_multi_mm``."""
    k = hs.shape[1]
    n = x.shape[-1]
    u_blk = min(u_blk, n)
    n_win = _cdiv(n, u_blk)
    xc = torch.cat([states, x], dim=-1)
    w3, t_win = _multi_band_matrix(hs, u_blk)
    xw = _gather_windows(xc, n_win, u_blk, t_win)
    y = torch.einsum("...wt,tcu->...cwu", xw, w3)
    y = y.reshape(y.shape[:-2] + (n_win * u_blk,))[..., :n]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


def fir_block_resample(x: torch.Tensor, h: torch.Tensor, state: torch.Tensor,
                       decim: int, upsamp: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming polyphase rational resampler, xU gain, as one gather and
    one multiply-reduce (port of ``sdr_tpu.ops.fir.fir_block_resample``)."""
    k = h.shape[0]
    t = _cdiv(k, upsamp)
    n = x.shape[-1]
    n_out = n * upsamp // decim
    if n_out * decim != n * upsamp:
        raise ValueError(f"block length {n} does not resample evenly by "
                         f"{upsamp}/{decim}")
    xc = torch.cat([state, x], dim=-1)
    xidx, nidx = _maps_on(_resample_maps, (n, k, decim, upsamp), x.device)
    hsel = torch.where(nidx < k, h[nidx.clamp(max=k - 1)], 0.0) * upsamp
    xwin = xc[..., xidx]                                 # (..., n_out, T)
    y = torch.einsum("...ot,ot->...o", xwin, hsel)
    new_state = xc[..., xc.shape[-1] - (t - 1):] if t > 1 else xc[..., :0]
    return y, new_state


def fir_block_resample_mm(x: torch.Tensor, h: torch.Tensor,
                          state: torch.Tensor, decim: int, upsamp: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded-matmul rational resampler (xU gain), one phase cycle of U
    outputs per window.  Falls back to :func:`fir_block_resample` when the
    block length is not a multiple of ``decim``, as the JAX form does.
    Port of ``sdr_tpu.ops.fir.fir_block_resample_mm``."""
    k = h.shape[0]
    t = _cdiv(k, upsamp)
    n = x.shape[-1]
    if n % decim != 0:
        return fir_block_resample(x, h, state, decim, upsamp)
    n_win = n // decim
    xc = torch.cat([state, x], dim=-1)
    w, t_win = _resample_band_matrix(h, decim, upsamp)
    xw = _gather_windows(xc, n_win, decim, t_win)
    y = torch.matmul(xw, w)
    y = y.reshape(y.shape[:-2] + (n_win * upsamp,))
    new_state = xc[..., xc.shape[-1] - (t - 1):] if t > 1 else xc[..., :0]
    return y, new_state


def allpass_delay(x: torch.Tensor, state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pure delay by len(state) samples (port of
    ``sdr_tpu.ops.fir.allpass_delay``)."""
    d = state.shape[-1]
    y = torch.cat([state, x[..., : x.shape[-1] - d]], dim=-1)
    new_state = x[..., x.shape[-1] - d:]
    return y, new_state
