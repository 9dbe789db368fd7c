"""train.mfu.xlstm: model FLOPs of the window's steps (the reference module's
``model_flops``) over the window's time, against 989 TFLOP/s bf16, in %."""
from portbench.core.readers import train_mfu as read  # noqa: F401
