"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): HBM bytes a second and float32 operations a second
outside the tensor cores. Each run prints the card's power limit beside
the shares it reports."""

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory rate."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
