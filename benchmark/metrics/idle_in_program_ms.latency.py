"""The device's idle time that lies inside the port's own host spans
(every ``sdr.``-prefixed span, their union), over the traced window, ms
per block: the time the card waited on the port's host work, read on the
profiler's clock, which host and device events share."""

from harness.trace import union


def read(t):
    lo, hi = t.window
    spans = union([(max(a, lo), min(b, hi)) for n, a, b in t.host
                   if n.startswith("sdr.") and b > lo and a < hi])
    if not spans:
        return None
    idle, i = 0.0, 0
    for a, b in t.gaps():
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            idle += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return 1e-3 * idle / t.blocks
