"""train.kernels_roofline.xlstm: Σ of the traced steps' calls' bounds over Σ
of their device time, in %, for the kernel files named here and no others
(a kernel file added later enters by a metric of its own)."""
from portbench.core.readers import kernel_share

KERNELS = ("mlstm_fwd", "mlstm_bwd", "slstm_fwd", "slstm_bwd")


def read(run):
    return kernel_share(run, KERNELS)
