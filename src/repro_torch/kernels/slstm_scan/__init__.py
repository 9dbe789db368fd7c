"""The sLSTM recurrence: CUDA kernels for Hopper and their plain PyTorch version."""
from repro_torch.kernels.slstm_scan.ops import slstm_scan
from repro_torch.kernels.slstm_scan.ref import slstm_scan_reference
