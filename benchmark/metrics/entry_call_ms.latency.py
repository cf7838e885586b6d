"""The median of the harness's own span around each ``Receiver.process``
call in the traced window, ms (host clock)."""

import statistics


def read(t):
    spans = t.spans_s("entry_call")
    return 1e3 * statistics.median(spans) if spans else None
