"""train.mlstm_fwd_roofline: the bound of the traced steps' calls of ``kernels/mlstm_fwd.py``
over its kernels' device time, in %."""
from portbench.core.readers import kernel_share


def read(run):
    return kernel_share(run, ["mlstm_fwd"])
