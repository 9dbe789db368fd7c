"""RG-LRU linear recurrence: CUDA kernel for Hopper and its plain PyTorch version."""
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_reference
