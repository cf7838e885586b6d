"""DSP primitives of the PyTorch port.

* ``fir``, ``demod``, ``pll`` — plain PyTorch (the JAX package's XLA ops);
* ``fir_frontend`` — kernel K1, the raw-u8 RF front-end, and its plain
  version;
* ``pll_cuda`` — kernels K2 (PLL angles) and K3 (PLL + NCO + mixer), and
  their plain versions.
"""
