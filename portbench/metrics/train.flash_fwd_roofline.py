"""train.flash_fwd_roofline: the bound of the traced steps' calls of ``kernels/flash_fwd.py``
over its kernels' device time, in %."""
from portbench.core.readers import kernel_share


def read(run):
    return kernel_share(run, ["flash_fwd"])
