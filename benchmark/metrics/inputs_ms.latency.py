"""The median of the port's span ``sdr.program.inputs`` in the traced
window, ms (the profiler's host clock): a block's key and signatures, the
params' version check and the state slot, before its load."""

import statistics


def read(t):
    spans = t.spans_s("sdr.program.inputs")
    return 1e3 * statistics.median(spans) if spans else None
