"""Work of one attention call (the count of ``chip_smoke.py::flash_bound``,
with the value head width apart from the query/key width, as MLA has it):
2*B*H*(d_qk + d_v) FLOP per kept (query, key) pair, S(S+1)/2 pairs when
causal; Q, K, V read once and O written once."""
from h100bench.work import peaks


def flops(b: int, h: int, s: int, d_qk: int, d_v: int,
          causal: bool = True) -> float:
    kept = s * (s + 1) // 2 if causal else s * s
    return 2.0 * b * h * (d_qk + d_v) * kept


def nbytes(b: int, h: int, s: int, d_qk: int, d_v: int,
           esize: int = 2) -> float:
    return float(b * h * s * (2 * d_qk + 2 * d_v) * esize)


def bound_s(b: int, h: int, s: int, d_qk: int, d_v: int,
            causal: bool = True) -> float:
    """Least time of one bf16 call at the bf16 tensor-core peak or HBM."""
    return peaks.bound_s(flops(b, h, s, d_qk, d_v, causal), peaks.BF16_FLOPS,
                         nbytes(b, h, s, d_qk, d_v))
