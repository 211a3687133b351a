"""Hand-written CUDA kernels for Hopper (sources in ``lpr_tpu_torch/csrc``),
their ctypes builder, and the plain PyTorch version beside each kernel."""
