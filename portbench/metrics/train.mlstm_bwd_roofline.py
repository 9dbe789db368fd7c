"""train.mlstm_bwd_roofline: the bound of the traced steps' calls of ``kernels/mlstm_bwd.py``
over its kernels' device time, in %."""
from portbench.core.readers import kernel_share


def read(run):
    return kernel_share(run, ["mlstm_bwd"])
