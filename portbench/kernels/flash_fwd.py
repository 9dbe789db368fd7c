"""Flash attention forward (``flash_tc_kernel`` at bf16, ``flash_cc_kernel``
else, ``kernels/flash_attention/csrc/flash_attention.cu``): one call a
global-attention layer in a prefill and a training step's forward (twice
under remat, writing the log-sum-exp beside o)."""
from portbench.core import shapes, work

DEVICE_NAMES = ("flash_tc_kernel", "flash_cc_kernel")
PRECISION = "bf16"


def calls(model, call):
    if call.phase == "decode":
        return []
    w = work.flash_forward(call.B, call.S, model["num_heads"], model["num_kv_heads"],
                           model["head_dim"], lse=call.phase == "train")
    return [w] * shapes.forwards(model, "attn", call)
