"""train.launches_per_step.xlstm: kernels the device ran in the traced steps,
a step (each kernel is one launch)."""
from portbench.core.readers import launches_per_step as read  # noqa: F401
