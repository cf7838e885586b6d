"""The wait for the previous span's copy to the card before the one
pinned staging buffer is refilled (the port's span
``sdr.program.staging_wait``), summed over the traced window, ms per
block step."""


def read(t):
    spans = t.spans_s("sdr.program.staging_wait")
    return 1e3 * sum(spans) / t.blocks if spans else None
