"""train.kernels_roofline.musicgen: Σ of the traced steps' calls' bounds over
Σ of their device time, in %, for the kernel files named here and no others
(a kernel file added later enters by a metric of its own)."""
from portbench.core.readers import kernel_share

KERNELS = ("flash_fwd", "flash_bwd")


def read(run):
    return kernel_share(run, KERNELS)
