"""The yardstick of the kernels' roofline shares.

A frozen copy of ``chip_smoke.py`` at commit 31744bf (``HBM_BYTES_PER_S``,
``FP32_OPS_PER_S``, ``_roofline`` and ``_fir_work``), with the published
peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit).  The work is that of the stage, from the cell's
shapes, whichever kernel does it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` moved and ``ops`` fp32 operations at
    the published peaks, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fir_work(n_in: int, in_size: int, n_out: int, taps: int,
             state: int) -> tuple[float, float]:
    """(bytes, operations) of a decimating FIR: each input read once, each
    output written once (float32), the state read and written (float32),
    the taps read once, one multiply-add (2 operations) per tap and
    output."""
    return (n_in * in_size + 4 * n_out + 8 * state + 4 * taps,
            2.0 * taps * n_out)


def frontend_work(cfg: dict, channels: int, blocks: int
                  ) -> tuple[float, float]:
    """(bytes, operations) of the RF front-end over ``blocks`` blocks of
    ``channels`` channels: the u8 block read once, the I and Q outputs at
    the IF rate written once, each arm's 150-sample state read and
    written, 2 operations per tap and output on I and on Q."""
    n_if = cfg["block_bytes"] // 2 // cfg["rf_decim"]
    taps = cfg["rf_taps"]
    nbytes, ops = fir_work(channels * cfg["block_bytes"], 1,
                           channels * 2 * n_if, taps,
                           channels * 2 * (taps - 1))
    return blocks * nbytes, blocks * ops
