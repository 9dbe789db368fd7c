"""The chunkwise mLSTM backward (``kernels/mlstm_chunk/csrc/mlstm_chunk_bwd.cu``:
at bf16 five tensor-core launches ``mlstm_bwd_tc_*``, else six CUDA-core
launches ``mlstm_bwd_*``), one call a layer in a training step. Its bound
counts the backward's own work (``work.mlstm_backward``)."""
from portbench.core import shapes, work

DEVICE_NAMES = ("mlstm_bwd_",)
PRECISION = "bf16"
CHUNK = 256


def calls(model, call):
    H, dqk, dv = shapes.mlstm_dims(model)
    c = work.chunk_size(call.S, CHUNK)
    return [work.mlstm_backward(call.B, call.S, H, dqk, dv, c)] * \
        shapes.backwards(model, "mlstm", call)
