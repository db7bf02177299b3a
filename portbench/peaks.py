"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the yardstick of every roofline share and `mfu`."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of bytes over the
    memory bandwidth and operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])

