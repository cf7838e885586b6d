"""The host's wait for the device before each chunk's fetch (the port's
span ``sdr.receiver.wait``, a synchronize of the receiver's stream),
summed over the traced window, ms per block step."""


def read(t):
    spans = t.spans_s("sdr.receiver.wait")
    return 1e3 * sum(spans) / t.blocks if spans else None
