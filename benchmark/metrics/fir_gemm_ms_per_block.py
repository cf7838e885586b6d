"""Device time of the kernels that ``fir_gemm_ms_per_block.json`` lists
for ``ops.fir`` (the banded FIRs and resamplers as matrix products), ms
per block step."""


def read(t):
    s = t.kernel_s(t.data("fir_gemm_ms_per_block"))
    return None if s is None else 1e3 * s / t.blocks
