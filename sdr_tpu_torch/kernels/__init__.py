"""Build and load the port's hand-written CUDA kernels
(``sdr_tpu_torch/csrc``); see :mod:`sdr_tpu_torch.kernels.build`."""
