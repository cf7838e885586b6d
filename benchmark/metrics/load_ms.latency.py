"""The median of the port's span ``sdr.program.load`` in the traced
window, ms (the profiler's host clock): the copy of the host block into
the graph's static input."""

import statistics


def read(t):
    spans = t.spans_s("sdr.program.load")
    return 1e3 * statistics.median(spans) if spans else None
