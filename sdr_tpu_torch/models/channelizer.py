"""Wideband channelizer: one capture -> a batch of station basebands.

Port of ``sdr_tpu/models/channelizer.py``.  One wideband capture at
``fs_wide`` becomes the (C, 2*N) interleaved channel batch the receiver
consumes:

    z_k[n] = FIR( x[n] * exp(-j 2 pi f_k n / fs_wide) ), decimated to rf_fs

All C channels mix, filter and decimate at once: the mixer is a broadcast
complex multiply in PyTorch, and the anti-alias FIR is kernel K5
(``ops.fir_decim.fir_block_decim``) over the (C, 2 [I/Q], N_wide) stack.
Each channel's oscillator phase carries across blocks, so streaming is
continuous.  :meth:`Channelizer.process` runs the block as a block program
(``models.program``; the counterpart of the JAX package's jitted
``_channelize_block``): on the card a CUDA graph per block shape, its
state donated.  The mixer's host constants are made once: ``w_k`` and
``w_b`` per channelizer, the per-block phase advance once per block length.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.golden import filters as gfilt
from sdr_tpu_torch.models import program
from sdr_tpu_torch.models.receiver import pin_fp32_matmul, resolve_device
from sdr_tpu_torch.ops import fir_decim
from sdr_tpu_torch.ops.fir_frontend import normalize_u8

_F32 = torch.float32
_TWO_PI = 2.0 * np.pi
_K_BLK = 1024


class ChannelizerState(NamedTuple):
    fir: torch.Tensor     # (C, 2, taps-1) anti-alias FIR tails
    phi0: torch.Tensor    # (C,) carried mixer phase (wrapped)


class Channelizer:
    """Streaming wideband -> channel-batch front end on ``device``.

    ``offsets_hz`` are station carrier offsets relative to the capture
    center; ``fs_wide`` must be an integer multiple of ``mc.rf_fs``.
    ``process(block)`` takes interleaved wideband IQ (u8 or float, length
    2*N_wide with N_wide divisible by the decimation) and returns
    (C, 2*N_wide/decim) interleaved float32 on ``device``, ready for a
    batched ``Receiver``.  ``device`` defaults to the card; without one it
    raises unless ``device="cpu"`` is passed.  Creating one turns TF32 off
    (``models.receiver.pin_fp32_matmul``).  ``state`` is the block program's
    state buffers, overwritten in place by the next block (a state assigned
    to it is copied in), as :class:`~sdr_tpu_torch.models.receiver.Receiver`
    keeps its own.
    """

    def __init__(self, offsets_hz: Sequence[float], fs_wide: float,
                 mode: int | cfg.Mode | cfg.ModeConfig = 0,
                 taps: int = 151, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.mc = (mode if isinstance(mode, cfg.ModeConfig)
                   else cfg.get_mode_config(mode))
        self.fs_wide = float(fs_wide)
        self.decim = int(round(fs_wide / self.mc.rf_fs))
        if abs(fs_wide - self.decim * self.mc.rf_fs) > 1e-6:
            raise ValueError(f"fs_wide {fs_wide} must be an integer "
                             f"multiple of rf_fs {self.mc.rf_fs}")
        self.offsets = tuple(float(f) for f in offsets_hz)
        c = len(offsets_hz)
        # anti-alias below the post-decimation Nyquist rf_fs/2
        self.coeffs = torch.tensor(
            gfilt.lowpass_taps(taps, fs_wide, 0.45 * self.mc.rf_fs),
            dtype=_F32, device=self.device)
        self.state = ChannelizerState(
            fir=torch.zeros((c, 2, taps - 1), dtype=_F32, device=self.device),
            phi0=torch.zeros((c,), dtype=_F32, device=self.device))
        self.mixer = mixer_constants(self.offsets, self.fs_wide, self.device)
        self._steps: dict[int, torch.Tensor] = {}
        # the step holds the constants, not the channelizer: no reference
        # cycle keeps a captured graph alive past its channelizer
        mixer, steps, decim = self.mixer, self._steps, self.decim

        def block(iq, h, state):
            return _channelize_block(iq, h, state, *mixer,
                                     steps[iq.shape[-1] // 2], decim)
        self.program = program.Program(block, (self.offsets, self.fs_wide,
                                               self.decim))

    def phase_step(self, n: int) -> torch.Tensor:
        """The (C,) phase advance of an ``n``-sample block, made once per
        block length (a graph reads it by address)."""
        step = self._steps.get(n)
        if step is None:
            step = self._steps[n] = phase_step(self.offsets, self.fs_wide, n,
                                               self.device)
        return step

    def process(self, iq_wide) -> torch.Tensor:
        """One wideband block through the block program; a host block is
        copied straight into the program's static input."""
        if isinstance(iq_wide, np.ndarray) and not iq_wide.flags.writeable:
            iq_wide = np.array(iq_wide)  # torch wraps only writable memory
        blk = torch.as_tensor(iq_wide)
        if blk.dtype != torch.uint8:
            blk = blk.to(_F32)
        self.phase_step(blk.shape[-1] // 2)
        out, self.state = self.program(blk, self.coeffs, self.state)
        return out


# Mixer phases w_k*n must stay accurate over long blocks, beyond what
# float32 w*arange(n) gives (ulp ~0.1 rad at n ~ 1e6).  Decompose
# n = a*K + b with host float64 residues: ph = (w*K mod 2pi)*a +
# (w mod 2pi)*b, keeping every f32 product small.


def _w64(offsets: tuple, fs_wide: float) -> np.ndarray:
    return _TWO_PI * np.asarray(offsets, np.float64) / fs_wide


def mixer_constants(offsets: tuple, fs_wide: float,
                    device: torch.device | str
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_k, w_b), each (C, 1, 1) float32 on ``device``: every channel's
    phase step over ``_K_BLK`` samples and over one sample, reduced mod 2pi
    in host float64 and rounded once."""
    w64 = _w64(offsets, fs_wide)
    w_k = torch.tensor((w64 * _K_BLK) % _TWO_PI, dtype=_F32, device=device)
    w_b = torch.tensor(w64 % _TWO_PI, dtype=_F32, device=device)
    return w_k[:, None, None], w_b[:, None, None]


def phase_step(offsets: tuple, fs_wide: float, n: int,
               device: torch.device | str) -> torch.Tensor:
    """(C,) float32: the exact phase advance of an ``n``-sample block,
    ``w * n mod 2pi`` in host float64, rounded once."""
    return torch.tensor((_w64(offsets, fs_wide) * n) % _TWO_PI, dtype=_F32,
                        device=device)


def _channelize_block(iq: torch.Tensor, h: torch.Tensor,
                      state: ChannelizerState, w_k: torch.Tensor,
                      w_b: torch.Tensor, step: torch.Tensor, decim: int
                      ) -> tuple[torch.Tensor, ChannelizerState]:
    """One wideband block, eager (the body of the channelizer's block
    program): ``w_k``, ``w_b`` from :func:`mixer_constants` and ``step``
    from :func:`phase_step` for this block's length, all on ``iq``'s
    device."""
    if iq.dtype == torch.uint8:
        iq = normalize_u8(iq)
    i_w = iq[0::2]
    q_w = iq[1::2]
    n = i_w.shape[-1]
    if n % decim:
        raise ValueError(f"wideband block of {n} samples is not a multiple "
                         f"of the decimation {decim}")
    dev = iq.device
    c = w_k.shape[0]

    # The sum (w*K mod 2pi)*a mod 2pi + (w mod 2pi)*b is rounded once, as
    # a fused multiply-add (XLA contracts it so on the CPU): its terms
    # reach ~6e3 rad, where one more f32 rounding moves the phase by ~2e-4.
    n_a = -(-n // _K_BLK)
    a = torch.arange(n_a, dtype=_F32, device=dev)[None, :, None]
    b = torch.arange(_K_BLK, dtype=_F32, device=dev)[None, None, :]
    # an f32 product is exact in f64, so this is a + w_b*b rounded once
    # (but for ties of the two roundings, ~2^-29 of the samples)
    fused = (torch.remainder(w_k * a, _TWO_PI).double()
             + w_b.double() * b.double()).float()
    ph = fused + state.phi0[:, None, None]
    ph = torch.remainder(ph, _TWO_PI).reshape(c, n_a * _K_BLK)[:, :n]
    c_m = torch.cos(ph)
    s_m = torch.sin(ph)
    # (x_i + j x_q) * e^{-j ph}
    mix_i = i_w[None, :] * c_m + q_w[None, :] * s_m
    mix_q = q_w[None, :] * c_m - i_w[None, :] * s_m

    stacked = torch.stack([mix_i, mix_q], dim=1)             # (C, 2, N)
    ds, new_fir = fir_decim.fir_block_decim(stacked, h, state.fir, decim)
    out = ds.movedim(1, -1).reshape(c, -1)                   # interleaved

    # exact per-block phase advance, computed in host float64
    phi0 = torch.remainder(state.phi0 + step, _TWO_PI)
    return out, ChannelizerState(fir=new_fir, phi0=phi0)
