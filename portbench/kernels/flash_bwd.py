"""Flash attention backward (``kernels/flash_attention/csrc/flash_attention_bwd.cu``:
``flash_bwd_tc_dq``, ``flash_bwd_tc_dkdv`` and ``flash_bwd_reduce`` at bf16),
one call a global-attention layer in a training step."""
from portbench.core import shapes, work

DEVICE_NAMES = ("flash_bwd_",)
PRECISION = "bf16"


def calls(model, call):
    w = work.flash_backward(call.B, call.S, model["num_heads"], model["num_kv_heads"],
                            model["head_dim"])
    return [w] * shapes.backwards(model, "attn", call)
