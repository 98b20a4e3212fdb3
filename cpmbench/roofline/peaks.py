"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit)."""

FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time of work of ``ops`` operations moving ``nbytes``
    bytes: the larger of the two at the peaks."""
    return max(ops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
