"""Spectral analysis: the DFT as a matrix product, and the Bartlett PSD.

Port of ``sdr_tpu/ops/spectrum.py``.  A direct DFT of a batch of
512-point segments is one (n_seg, 512) x (512, 512) complex product; the
PSD takes its segment spectra from ``torch.fft.fft`` or, with
``use_matmul_dft``, from one real product each against the cos and sin
bases.  The JAX package computes these outside any Pallas kernel, so they
are plain PyTorch here, in full fp32: TF32 is turned off for them on the
card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.ops.fir import pin_fp32_matmul

NFFT_DEFAULT = 512  # include/dy4.h:27


@functools.lru_cache(maxsize=8)
def _dft_matrix(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _bases_on(n: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The DFT matrix and the cos and sin bases of its first n/2 columns,
    as tensors on ``device``, made once per size and device."""
    w = _dft_matrix(n)
    half = w[:, :n // 2]
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(np.ascontiguousarray(half.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(half.imag)).to(device))


def _on_device(x: torch.Tensor) -> None:
    if x.is_cuda:
        pin_fp32_matmul()


def dft_matmul(x: torch.Tensor) -> torch.Tensor:
    """DFT of the last axis as a matrix product (ref semantics
    src/fourier.cpp:15-23), complex64."""
    _on_device(x)
    w = _bases_on(x.shape[-1], x.device)[0]
    return torch.matmul(x.to(torch.complex64), w)


def idft_matmul(xf: torch.Tensor) -> torch.Tensor:
    """Inverse DFT with 1/N scaling (ref: src/fourier.cpp:132-141)."""
    _on_device(xf)
    n = xf.shape[-1]
    w = _bases_on(n, xf.device)[0]
    return torch.matmul(xf.to(torch.complex64), w.conj()) / n


def hann_sin2(n: int) -> np.ndarray:
    i = np.arange(n)
    return (np.sin(i * np.pi / n) ** 2).astype(np.float32)


def estimate_psd(samples: torch.Tensor, nfft: int = NFFT_DEFAULT,
                 fs: float = 1.0, use_matmul_dft: bool = False
                 ) -> tuple[np.ndarray, torch.Tensor]:
    """Bartlett PSD in dB/Hz over the positive frequencies, of the golden
    estimate's semantics (model/fmSupportLib.py:554-631): Hann-windowed
    segments of ``nfft``, their power doubled, in dB, averaged.  Takes
    leading batch dims.  Returns (freq, numpy (nfft/2,); psd_db, a tensor
    (..., nfft/2) on the samples' device).

    ``use_matmul_dft=True`` takes the segment spectra as one real
    (n_seg, nfft) x (nfft, nfft/2) product against each of the cos and sin
    bases instead of the FFT."""
    samples = torch.as_tensor(samples, dtype=torch.float32)
    n_seg = samples.shape[-1] // nfft
    half = nfft // 2
    win = torch.from_numpy(hann_sin2(nfft)).to(samples.device)
    seg = samples[..., :n_seg * nfft].reshape(
        samples.shape[:-1] + (n_seg, nfft)) * win
    if use_matmul_dft:
        _on_device(seg)
        _, wr, wi = _bases_on(nfft, samples.device)
        re, im = torch.matmul(seg, wr), torch.matmul(seg, wi)
        mag2 = re * re + im * im
    else:
        mag2 = torch.fft.fft(seg, nfft, dim=-1)[..., :half].abs() ** 2
    psd_db = 10.0 * torch.log10(2.0 * mag2 / (fs * nfft / 2))
    freq = np.arange(0, fs / 2, fs / nfft)[:half]
    return freq, psd_db.mean(dim=-2)
