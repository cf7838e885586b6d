"""Host-side RDS symbol -> bit -> frame decode (numpy).

Port of ``decode_robust`` and ``_info_words`` of
``sdr_tpu/models/rds_decode.py``, whose package imports JAX.  The chain runs
at 2375 symbols/s and is control-flow heavy, so it stays on the host; it
calls the shared numpy oracle ``sdr_tpu.golden.rds``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdr_tpu.golden import rds as grds


@dataclasses.dataclass
class RdsDecodeResult:
    bits: np.ndarray                      # post-differential-decode bits
    frames: grds.FrameSyncResult
    info_words: np.ndarray                # (n_frames, 16) info bits per match
    n_corrected: int = 0                  # frames saved by burst correction


def _info_words(bits: np.ndarray,
                frames: grds.FrameSyncResult) -> np.ndarray:
    return np.array([bits[pos:pos + 16] for pos, _ in frames.matches],
                    dtype=np.int64).reshape(-1, 16)


def decode_robust(symbols: np.ndarray, sps: int,
                  window_symbols: int | None = None,
                  error_correction: bool = False) -> RdsDecodeResult:
    """Decode a whole soft-symbol stream (concatenated RRC outputs).

    ``symbols`` may be (n_blocks, sym_len) stacked output or a flat stream;
    blocks are concatenated in time order.  ``window_symbols`` enables the
    clock-drift-tracking CDR; ``error_correction`` applies the burst-<=5
    block correction while frame-synchronized, and info words then come
    from the corrected windows."""
    x = np.asarray(symbols).reshape(-1)
    if window_symbols:
        manch = grds.cdr_tracking(x, sps, window_symbols)
    else:
        manch, _, _ = grds.cdr_robust(x, sps)
    bits = grds.diff_decode(manch)
    if error_correction:
        ec = grds.frame_sync_ec(bits)
        matches = [(p, o) for p, o, _, _ in ec.matches]
        frames = grds.FrameSyncResult(
            matches, ec.consumed, matches[-1][1] if matches else "")
        info = (np.stack([w[:16] for _, _, w, _ in ec.matches])
                if ec.matches else np.zeros((0, 16), np.int64))
        return RdsDecodeResult(bits, frames, info,
                               sum(1 for _, _, _, ne in ec.matches if ne))
    frames = grds.frame_sync(bits)
    return RdsDecodeResult(bits, frames, _info_words(bits, frames))
