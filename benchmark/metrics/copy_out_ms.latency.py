"""The median of the port's span ``sdr.program.copy_out`` in the traced
window, ms (the profiler's host clock): the copy of the graph's outputs
into fresh tensors."""

import statistics


def read(t):
    spans = t.spans_s("sdr.program.copy_out")
    return 1e3 * statistics.median(spans) if spans else None
