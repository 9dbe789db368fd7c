"""Batched WS request-queue core: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.queue_core.ops import queue_core, queue_flush
from repro_torch.kernels.queue_core.ref import queue_core_reference, queue_flush_reference
