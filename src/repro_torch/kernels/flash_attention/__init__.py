"""Flash attention: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
