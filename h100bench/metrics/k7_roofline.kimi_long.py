"""K7's share of its roofline on the MLA layers: the least time of every
attention call of the slice's prefills (``work/kimi_linear.py``: 2*H*(d_qk
+ d_v) FLOP a kept pair at the bf16 peak, or the bytes at HBM rate), over
the measured time of the K7 launches, whichever variant ran."""
from h100bench import readers
from h100bench.work import kimi_linear


def read(run):
    r = run.record
    bound = sum(kimi_linear.attention_bound_s(r["sizes"], r["batch"], s)
                for s in r["lengths_in"])
    return readers.roofline_pct(run, readers.K7_KERNELS, bound)
