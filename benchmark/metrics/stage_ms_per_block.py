"""The host copy of each chunk span into pinned staging (the port's span
``sdr.program.stage``), summed over the traced window, ms per block
step."""


def read(t):
    spans = t.spans_s("sdr.program.stage")
    return 1e3 * sum(spans) / t.blocks if spans else None
