"""Matplotlib visual inspection: PSD plots + RDS constellation.

Reference: ``fmPlotPSD`` (model/fmSupportLib.py:634-662) and the IQ
constellation scatter used to tune the RDS PLL phase
(model/fmRDS.py:140-142,305-307).  Visual/spectral inspection is the
reference's verification tier for physical-world interfaces with no exact
oracle (SURVEY.md §4.3).

The port's own copy of ``sdr_tpu/utils/plotting.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def plot_psd(ax, samples: np.ndarray, fs: float, nfft: int = 512,
             height_label: str = "PSD (dB/Hz)") -> None:
    """Bartlett PSD onto a matplotlib axis (model/fmSupportLib.py:634-662).
    Frequency axis in kHz like the reference."""
    from sdr_tpu_torch.golden.spectrum import estimate_psd
    freq, psd = estimate_psd(np.asarray(samples, dtype=np.float64),
                             nfft, fs)
    ax.plot(freq / 1e3, psd)
    ax.set_xlabel("Frequency (kHz)")
    ax.set_ylabel(height_label)
    ax.grid(True, alpha=0.3)


def save_psd_png(path: str, samples: np.ndarray, fs: float,
                 nfft: int = 512, title: str = "") -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 4))
    plot_psd(ax, samples, fs, nfft)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_constellation_png(path: str, i_samples: np.ndarray,
                           q_samples: np.ndarray, title: str = "RDS IQ"
                           ) -> str:
    """BPSK constellation scatter (model/fmRDS.py:305-307): tight clusters
    on the I axis mean a well-tuned carrier-recovery phase."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(i_samples, q_samples, s=4, alpha=0.4)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.axhline(0, color="k", lw=0.5)
    ax.axvline(0, color="k", lw=0.5)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
