"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each
returns None where its slice or its counters hold nothing to read."""
from __future__ import annotations

from h100bench.trace import device_seconds

# the CUDA kernels of K1-K5 (``repro_torch/kernels/csrc``) and of K7
BCNN_KERNELS = ("xnor_matmul_vpu_kernel", "xnor_gemv_kernel",
                "xnor_matmul_mxu_kernel", "xnor_conv2d_vpu_kernel",
                "xnor_conv2d_mxu_kernel", "pair_vpu_kernel",
                "pair_mxu_kernel")
K7_KERNELS = ("flash_simt_kernel", "flash_attention_tc_kernel")


def summary(run):
    s = run.tracer.summary if run.tracer is not None else None
    return s if s and s["kernels"] else None


def kernel_ms_per(run, count_key: str, names=None):
    """Device ms of the slice's kernels (copies left out) per unit of the
    record's ``count_key`` counted inside the slice."""
    s, n = summary(run), run.record.get(count_key, 0)
    if s is None or not n:
        return None
    t = device_seconds(s, names, copies=False)
    return t * 1e3 / n if t > 0 else None


def copy_ms_per(run, count_key: str):
    s, n = summary(run), run.record.get(count_key, 0)
    if s is None or not n:
        return None
    t = device_seconds(s, copies=True)
    return t * 1e3 / n if t > 0 else None


def roofline_pct(run, names, bound_s: float):
    """100 x (least time of the slice's work) / (the named kernels' time)."""
    s = summary(run)
    if s is None or bound_s <= 0:
        return None
    t = device_seconds(s, names, copies=False)
    return 100.0 * bound_s / t if t > 0 else None


def idle_pct(run):
    s = summary(run)
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def share_pct(work: float, seconds: float, peak: float):
    """100 x work / (seconds x peak): a share of the card's peak."""
    if work <= 0 or seconds <= 0:
        return None
    return 100.0 * work / seconds / peak
