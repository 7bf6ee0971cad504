"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each
beside its plain PyTorch version (``ref``); ``ops`` dispatches by the
tensors' device."""
