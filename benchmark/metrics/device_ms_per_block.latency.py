"""The union of the device's intervals (kernels, copies, sets) per block
in the traced window, ms."""


def read(t):
    return 1e3 * t.busy_s / t.blocks if t.device else None
