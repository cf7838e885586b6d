"""sdr_tpu_torch — the FM receiver of ``sdr_tpu`` in PyTorch, with CUDA
kernels hand-written for Hopper (H100).

Raw 8-bit interleaved I/Q in; mono, stereo L/R and RDS out.  The package
mirrors ``sdr_tpu``'s layout and contracts, and the JAX package is the
reference its tests hold it against.  It imports ``torch`` and never
``jax``, and nothing of ``sdr_tpu``: it keeps its own copies of the numpy
modules it needs (``config``, ``golden.filters``, ``golden.rds``, ``io``,
``utils.synth``) and its own binding of the shared C++ host runtime
(``native``).  Its entry points run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``.

* ``sdr_tpu_torch.ops``        — FIRs, FM demod and PLL in plain PyTorch,
  and the kernel wrappers (``fir_frontend``: K1, K4; ``fir_decim``: K5;
  ``pll_cuda``: K2, K3)
* ``sdr_tpu_torch.models``     — the per-block receiver DAG, the wideband
  channelizer, and the host RDS decode and group layer
* ``sdr_tpu_torch.parallel``   — the scale-out layer: a channel batch
  sharded over devices, and one recording time-sharded over S shards
  with the halo exchange K6 (``parallel.halo``); a ``Mesh`` may name one
  card S times, and the shards that share a card run as one batch
* ``sdr_tpu_torch.cli``        — the command-line receiver,
  ``python -m sdr_tpu_torch.cli``
* ``sdr_tpu_torch.checkpoint`` — the receiver state as ``.npz``, in the
  JAX package's format
* ``sdr_tpu_torch.csrc``       — the CUDA C++ kernel sources
* ``sdr_tpu_torch.kernels``    — builds them with nvcc at first use
* ``sdr_tpu_torch.convert``    — coefficients and state to and from the
  JAX package
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from sdr_tpu_torch.config import (  # noqa: F401
    Mode,
    ModeConfig,
    custom_mode,
    get_mode_config,
)


@dataclasses.dataclass
class ReceiveResult:
    """One-call receive output: concatenated audio + decoded RDS."""

    audio_fs: float
    mono: np.ndarray
    left: Optional[np.ndarray]
    right: Optional[np.ndarray]
    rds_frames: list
    rds_info_words: np.ndarray


def receive(iq, mode: int | Mode | ModeConfig = 0, stereo: bool = True,
            rds: bool = True, device: torch.device | str = "cuda"
            ) -> ReceiveResult:
    """Demodulate a whole capture in one call on ``device`` (default the
    card; without one it raises unless ``device="cpu"`` is passed).

    ``iq`` is a path to a raw interleaved-u8 file, a u8 array, or a
    normalized float array.  Returns concatenated audio (mono always;
    left/right when ``stereo``) and decoded RDS frames/info words.  The
    capture is consumed to the last whole block multiple (a short tail is
    processed as a final smaller block, not dropped).  The whole blocks
    stream through ``Receiver.run``: on the card one CUDA graph per
    ``models.receiver.SCAN_BLOCKS`` blocks, the block's graph for the rest.
    TF32 is turned off (see ``models.receiver.pin_fp32_matmul``).
    """
    from sdr_tpu_torch.models import rds_decode
    from sdr_tpu_torch.models import receiver as rx

    device = rx.resolve_device(device)
    if isinstance(iq, (str, os.PathLike)):
        iq = np.fromfile(iq, dtype=np.uint8)
    iq = np.asarray(iq)
    mc = mode if isinstance(mode, ModeConfig) else get_mode_config(mode)
    with_rds = rds and mc.rds is not None
    gran = mc.if_block_multiple(with_rds) * 2 * mc.rf_decim
    usable = len(iq) // gran * gran
    if usable == 0:
        raise ValueError(
            f"capture of {len(iq)} samples is shorter than one block "
            f"multiple ({gran} interleaved u8 samples) for mode "
            f"{int(mc.mode)}{' with RDS' if with_rds else ''}")
    r = rx.Receiver(mc, stereo=stereo, with_rds=with_rds, device=device)
    bs = min(mc.default_block_size(with_rds), usable)
    parts = [r.run(iq[:usable // bs * bs], block_size=bs)]
    tail = iq[usable // bs * bs: usable]
    if len(tail):
        parts.append(r.process(tail))

    flat = lambda arrs: np.concatenate(
        [a.detach().cpu().numpy().reshape(-1) for a in arrs])
    frames: list = []
    words = np.zeros((0, 16), np.int64)
    if with_rds:
        dec = rds_decode.decode_robust(
            flat([p.rds_symbols for p in parts]), mc.rds.sps)
        frames = dec.frames.matches
        words = dec.info_words
    return ReceiveResult(
        audio_fs=mc.audio_fs,
        mono=flat([p.mono for p in parts]),
        left=flat([p.left for p in parts]) if stereo else None,
        right=flat([p.right for p in parts]) if stereo else None,
        rds_frames=frames,
        rds_info_words=words,
    )
