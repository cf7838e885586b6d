"""The copy of each chunk's outputs to host numpy (the port's span
``sdr.receiver.fetch``), summed over the traced window, ms per block
step."""


def read(t):
    spans = t.spans_s("sdr.receiver.fetch")
    return 1e3 * sum(spans) / t.blocks if spans else None
