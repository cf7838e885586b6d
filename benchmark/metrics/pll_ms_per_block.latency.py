"""Device time of the PLL kernel that ``pll_ms_per_block.latency.json``
lists (K2 at one channel), ms per block."""


def read(t):
    s = t.kernel_s(t.data("pll_ms_per_block.latency"))
    return None if s is None else 1e3 * s / t.blocks
