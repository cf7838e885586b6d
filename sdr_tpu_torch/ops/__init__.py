"""DSP primitives of the PyTorch port.

* ``fir``, ``demod``, ``pll`` — plain PyTorch (the JAX package's XLA ops);
* ``fir_frontend`` — kernel K1, the raw-u8 RF front-end, K4, the same
  function in deinterleaved int8 form, and their plain version;
* ``fir_decim`` — kernel K5, the decimating FIR of float input (the
  receiver's float front-end, the channelizer's anti-alias FIR), and its
  plain version;
* ``pll_cuda`` — kernels K2 (PLL angles) and K3 (PLL + NCO + mixer), and
  their plain versions.
"""
