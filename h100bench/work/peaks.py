"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit). Every roofline share and mfu of the benchmark divides by
these; the card's own ``power.limit`` is printed beside each result."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores, dense
INT8_OPS = 1979e12           # int8 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # HBM3

# The data sheet gives no 1-bit rate. The A100 data sheet's binary tensor
# core rate is 8x its int8 rate (4,992 vs 624 TOPS), and the H100's own
# `mma.sync .b1 .and.popc` probe already reads above 4x its int8 rate, so
# 8x is the least power-of-two ratio the card bears out: 15,832 TOP/s
# (1 op = one XNOR or one accumulate; a bit-MAC is 2 ops). Listed under
# `assumed` in configs/bcnn-cifar10.json.
B1_OPS = 8 * INT8_OPS


def bound_s(ops: float, rate: float, nbytes: float) -> float:
    """The least time for work of ``ops`` at ``rate`` moving ``nbytes`` of
    device memory: the larger of the two terms."""
    return max(ops / rate, nbytes / HBM_BYTES_PER_S)
