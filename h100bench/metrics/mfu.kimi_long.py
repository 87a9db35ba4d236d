"""The prefill's share of the bf16 peak: the FLOPs the model needs for the
prompts answered outside the traced slice (``work/kimi_linear.py``) over
the window's time outside it."""
from h100bench import readers
from h100bench.work import peaks


def read(run):
    r = run.record
    return readers.share_pct(r["flops_out"], r["time_out"], peaks.BF16_FLOPS)
