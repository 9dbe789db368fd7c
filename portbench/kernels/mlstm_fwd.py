"""The chunkwise mLSTM forward (``kernels/mlstm_chunk/csrc/mlstm_chunk.cu``:
bf16 state and output passes on the tensor cores). Called in a prefill and
in a training step's forward (twice under remat); the decode step's mLSTM
is plain PyTorch, not this kernel. ``calls`` gives the (operations, bytes)
of each call in one call into the model."""
from portbench.core import shapes, work

DEVICE_NAMES = ("mlstm_state_kernel", "mlstm_out_kernel", "mlstm_chunk_kernel")
PRECISION = "bf16"
CHUNK = 256


def calls(model, call):
    if call.phase == "decode":
        return []
    H, dqk, dv = shapes.mlstm_dims(model)
    c = work.chunk_size(call.S, CHUNK)
    return [work.mlstm(call.B, call.S, H, dqk, dv, c)] * shapes.forwards(model, "mlstm", call)
