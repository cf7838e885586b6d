"""Numpy golden model — the CPU-runnable correctness oracle.

The port's own copy of ``sdr_tpu/golden``: coefficient design, stateful
streaming FIR kernels, FM discriminators, PLL, the RDS symbol/bit/frame
chain, spectral analysis and the float64 block-streaming receiver
(``golden.receiver``).  Everything here is plain float64 numpy with
explicit ``(y, state)`` streaming contracts, behaviour unchanged from the
JAX package's, so that the port can be held to it on a machine without
JAX: the receiver on the card against ``golden.receiver.run_file``
(``chip_smoke.py``).
"""

from sdr_tpu_torch.golden.filters import (  # noqa: F401
    lowpass_taps,
    bandpass_taps,
    rrc_taps,
    fir_full,
    block_fir,
    block_fir_decim,
    block_fir_resample,
    allpass_delay,
)
from sdr_tpu_torch.golden.demod import (  # noqa: F401
    fm_demod_quad,
    fm_demod_arctan,
)
from sdr_tpu_torch.golden.pll import PllState, fm_pll  # noqa: F401
from sdr_tpu_torch.golden.rds import (  # noqa: F401
    PARITY_MATRIX,
    SYNDROMES,
    gf2_syndrome,
    frame_sync,
    cdr,
    manchester_decode,
    diff_decode,
)
from sdr_tpu_torch.golden.spectrum import dft, estimate_psd  # noqa: F401
