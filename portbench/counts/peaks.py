"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_F32_PER_S = 67e12       # float32 outside the tensor cores (TF32 off)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take for the work: the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)
