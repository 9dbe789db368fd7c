"""Decode attention: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
