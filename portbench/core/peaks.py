"""Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates, 700 W).

Frozen copy of ``HW`` in ``src/repro_torch/launch/mesh.py`` (commit 02043fe),
kept here so that a change to the program cannot move the yardstick.
"""

BF16_FLOPS = 989e12      # FLOP/s, bf16 tensor cores
FP32_FLOPS = 67e12       # FLOP/s, float32 CUDA cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9

RATES = {"bf16": BF16_FLOPS, "fp32": FP32_FLOPS}


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: operations at the peak of
    ``precision`` (``"bf16"`` or ``"fp32"``) or bytes at HBM bandwidth,
    whichever is longer."""
    return max(flops / RATES[precision], nbytes / HBM_BYTES_PER_S)
