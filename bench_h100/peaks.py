"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's H100 Tensor
Core GPU data sheet, no sparsity), as the program's launch/roofline.py
states them.  The peaks assume the card's full 700 W power limit."""

PEAK_OPS = {
    "fp32": 67e12,       # float32 FMA outside the tensor cores
    "int8": 1979e12,     # int8 on the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of operations at
    the peak and bytes at the HBM rate."""
    return max(ops / PEAK_OPS[peak], nbytes / HBM_BYTES_PER_S)
