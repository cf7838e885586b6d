"""The end-to-end arithmetic over a measured window, kept apart from the
drivers so that it can be checked on synthetic samples."""

from __future__ import annotations

import numpy as np


def rate_msps(samples: int, t_first: float, t_last: float) -> float:
    """Complex samples per second, in millions, over the whole window:
    every sample whose outputs reached the host, over the time from the
    first submission to the last completion."""
    return samples / (t_last - t_first) / 1e6


def percentile_ms(latencies_s, q: float) -> float:
    """The ``q``-th percentile of every latency of the window, in ms
    (numpy's linear interpolation between the order statistics)."""
    return float(np.percentile(np.asarray(latencies_s) * 1e3, q))


def late(latencies_s, limit_s: float) -> int:
    """How many requests finished later than ``limit_s`` after they were
    due."""
    return int(np.count_nonzero(np.asarray(latencies_s) > limit_s))
