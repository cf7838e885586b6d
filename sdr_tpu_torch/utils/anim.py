"""Live per-block PSD animation (reference model/fmMonoAnim.py).

The reference drives a matplotlib ``FuncAnimation`` that re-estimates the
PSD of selected taps of the chain for each processed block
(model/fmMonoAnim.py:44-92,132-139).  Here the same view runs over the
port's receiver, block by block through its block program on ``device``
(the card by default), with the PSD of the port's float64
``golden.spectrum.estimate_psd``; headless use saves a .gif, interactive
use shows the window.  The port's counterpart of ``sdr_tpu/utils/anim.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sdr_tpu_torch import config as cfg


def animate_psd(iq: np.ndarray, mode: int | cfg.Mode = 0,
                arm: str = "fm_demod", nfft: int = 512,
                out_path: Optional[str] = None, fps: int = 4,
                max_blocks: Optional[int] = None, device="cuda"):
    """Animate the per-block PSD of one receiver arm over a recording.

    ``arm`` is any BlockOutputs field ("fm_demod", "mono", "left", ...).
    With ``out_path`` (.gif) the animation is rendered headless; otherwise
    the figure is returned for ``plt.show()``.  The receiver runs on
    ``device`` and raises without a card unless ``device="cpu"``.
    """
    from sdr_tpu_torch.golden.spectrum import estimate_psd
    from sdr_tpu_torch.models import receiver as rx

    mc = cfg.get_mode_config(mode)
    with_rds = arm.startswith("rds")
    if with_rds and mc.rds is None:
        raise ValueError(f"mode {mode} carries no RDS; cannot animate {arm}")
    receiver = rx.Receiver(mode, stereo=arm in ("left", "right"),
                           with_rds=with_rds, device=device)

    import matplotlib
    if out_path:
        matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt

    bs = mc.default_block_size(with_rds)
    n_blocks = len(iq) // bs
    if max_blocks:
        n_blocks = min(n_blocks, max_blocks)
    if arm == "fm_demod":
        fs = mc.if_fs
    elif with_rds:
        fs = mc.rds.symbol_fs
    else:
        fs = mc.audio_fs

    psds = []
    for b in range(n_blocks):
        out = receiver.process(iq[b * bs:(b + 1) * bs])
        x = getattr(out, arm).cpu().numpy().astype(np.float64)
        psds.append(estimate_psd(x, nfft, fs))

    fig, ax = plt.subplots(figsize=(9, 4))
    freq = psds[0][0]
    line, = ax.plot(freq / 1e3, psds[0][1])
    lo = min(p.min() for _, p in psds)
    hi = max(p.max() for _, p in psds)
    ax.set_ylim(lo - 3, hi + 3)
    ax.set_xlabel("Frequency (kHz)")
    ax.set_ylabel("PSD (dB/Hz)")
    ax.grid(True, alpha=0.3)
    title = ax.set_title(f"{arm} PSD — block 0/{n_blocks}")

    def update(frame):
        line.set_ydata(psds[frame][1])
        title.set_text(f"{arm} PSD — block {frame}/{n_blocks}")
        return line, title

    ani = manim.FuncAnimation(fig, update, frames=n_blocks,
                              interval=1000 // fps, blit=False)
    if out_path:
        ani.save(out_path, writer=manim.PillowWriter(fps=fps))
        plt.close(fig)
        return out_path
    return ani
