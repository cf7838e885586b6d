"""DSP primitives of the PyTorch port.

* ``fir``, ``demod``, ``pll``, ``spectrum`` — plain PyTorch (the JAX
  package's XLA ops);
* ``fir_frontend`` — kernel K1, the raw-u8 RF front-end, K4, the same
  function in deinterleaved int8 form, and their plain version;
* ``fir_decim`` — kernel K5, the decimating FIR of float input (the
  receiver's float front-end, the channelizer's anti-alias FIR), and its
  plain version;
* ``pll_cuda`` — kernels K2 (PLL angles) and K3 (PLL + NCO + mixer), and
  their plain versions.

The package exports the names ``sdr_tpu.ops`` exports, with its
contracts; ``fir_block`` and ``fir_block_decim`` are the banded forms
(the JAX package's convolution forms are not ported).
"""

from sdr_tpu_torch.ops.demod import fm_demod_arctan, fm_demod_quad  # noqa: F401
from sdr_tpu_torch.ops.fir import (  # noqa: F401
    allpass_delay,
    fir_block,
    fir_block_decim,
    fir_block_resample,
    resample_state_len,
)
from sdr_tpu_torch.ops.pll import PllParams, pll_block, pll_init  # noqa: F401
from sdr_tpu_torch.ops.spectrum import dft_matmul, estimate_psd  # noqa: F401
