"""The median of the port's span ``sdr.program.replay`` in the traced
window, ms (the profiler's host clock): the block graph's launch."""

import statistics


def read(t):
    spans = t.spans_s("sdr.program.replay")
    return 1e3 * statistics.median(spans) if spans else None
