"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version; built by ``_build`` at first use."""
