"""The sLSTM recurrence (``slstm_scan_kernel`` in
``kernels/slstm_scan/csrc/slstm_scan.cu``, float32): one call a layer in a
prefill, a decode step (S = 1) and a training step's forward (twice under
remat, keeping what the backward needs)."""
from portbench.core import shapes, work

DEVICE_NAMES = ("slstm_scan_kernel",)
PRECISION = "fp32"


def calls(model, call):
    H = model["num_heads"]
    dh = model["d_model"] // H
    S = 1 if call.phase == "decode" else call.S
    return [work.slstm(call.B, S, H, dh, saved=call.phase == "train")] * \
        shapes.forwards(model, "slstm", call)
