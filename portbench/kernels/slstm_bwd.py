"""The sLSTM backward (``slstm_scan_bwd_kernel``, float32), one call a layer
in a training step; drec is a product outside it and not counted here."""
from portbench.core import shapes, work

DEVICE_NAMES = ("slstm_scan_bwd_kernel",)
PRECISION = "fp32"


def calls(model, call):
    H = model["num_heads"]
    return [work.slstm_backward(call.B, call.S, H, model["d_model"] // H)] * \
        shapes.backwards(model, "slstm", call)
