"""Device time of the host-to-device and device-to-host copies (the block
program's staging and the fetch of the outputs), ms per block step."""


def read(t):
    s = t.device_s(t.is_copy)
    return 1e3 * s / t.blocks if s > 0 else None
