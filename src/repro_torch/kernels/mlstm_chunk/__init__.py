"""Chunkwise mLSTM: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_reference
