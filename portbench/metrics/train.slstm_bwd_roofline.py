"""train.slstm_bwd_roofline: the bound of the traced steps' calls of ``kernels/slstm_bwd.py``
over its kernels' device time, in %."""
from portbench.core.readers import kernel_share


def read(run):
    return kernel_share(run, ["slstm_bwd"])
