"""Device time of every kernel that is not a copy or a set (the block DAG
in the chunk graphs), ms per block step."""


def read(t):
    s = t.device_s(lambda n: not t.is_copy(n) and not t.is_set(n))
    return 1e3 * s / t.blocks if s > 0 else None
