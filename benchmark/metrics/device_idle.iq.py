"""The device's idle share over the traced window: 1 - the union of
kernel, copy and set intervals over the window's length, in %."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
