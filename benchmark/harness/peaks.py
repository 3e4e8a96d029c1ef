"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every roofline and mfu
share of the benchmark is taken against these numbers: float32 work
against the TF32 rate, whatever route a kernel takes to compute it.
"""

PEAK_OPS = {
    "int8": 1979e12,   # TOP/s
    "bf16": 989e12,    # FLOP/s
    "tf32": 495e12,    # FLOP/s: the rate that float32 work is held to
}
HBM_BYTES_S = 3.35e12  # HBM3, bytes/s


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time one H100 could take: the larger of ``ops`` at the peak
    of ``precision`` and ``nbytes`` at the memory rate."""
    return max(ops / PEAK_OPS[precision], nbytes / HBM_BYTES_S)
