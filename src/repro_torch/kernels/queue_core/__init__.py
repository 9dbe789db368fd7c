"""Batched WS request-queue core: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.queue_core.ops import queue_core
from repro_torch.kernels.queue_core.ref import queue_core_reference
