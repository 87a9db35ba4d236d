"""Arithmetic the readers of the program's own spans and counters share
(``repro_torch/trace.py``: recording is on while the traced slice's
profiler runs, so what it holds is the slice's). Span times are Unix-epoch
ns, the clock of the slice's device intervals (``summary["kernels"]``).
Each function returns None where the slice recorded nothing it reads, and
so does every reader on a program that has no tracer."""
from __future__ import annotations

import numpy as np

from h100bench import readers
from h100bench.trace import _gaps


def program_trace(run):
    """(spans, counters) the program recorded in the traced slice, drained
    once and kept in the run's record; None without a tracer or a slice."""
    rec = run.record
    if "program_trace" not in rec:
        rec["program_trace"] = None
        if run.trace:
            try:
                from repro_torch import trace
            except ImportError:
                return None
            rec["program_trace"] = trace.drain()
    return rec["program_trace"]


def spans(run, names) -> list[dict]:
    """The slice's spans whose name is in ``names``."""
    got = program_trace(run)
    return [] if got is None else [s for s in got[0] if s["name"] in names]


def counter(run, name):
    got = program_trace(run)
    return None if got is None else got[1].get(name)


def host_ms_per(run, name: str, per: str):
    """Summed host ms of the ``name`` spans over the number of ``per``
    spans."""
    n = len(spans(run, (per,)))
    sel = spans(run, (name,))
    if not n or not sel:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in sel) / 1e6 / n


def device_ms_per_ktok(run, names):
    """Summed device ms of the ``names`` spans per 1,000 prompt tokens of
    the slice (the record's ``tokens_in``)."""
    sel = [s["device_ms"] for s in spans(run, names)
           if s["device_ms"] is not None]
    n = run.record.get("tokens_in", 0)
    if not sel or not n:
        return None
    return sum(sel) * 1e3 / n


def ratio_pct(num, den):
    if num is None or not den:
        return None
    return 100.0 * num / den


def covered_ns(starts: np.ndarray, ends: np.ndarray, t: np.ndarray
               ) -> np.ndarray:
    """For each time in ``t``: ns before it covered by the disjoint sorted
    intervals [starts, ends)."""
    done = np.concatenate(([0], np.cumsum(ends - starts)))
    i = np.searchsorted(starts, t, side="right")   # intervals begun by t
    last = np.maximum(i - 1, 0)
    part = np.clip(t - starts[last], 0, ends[last] - starts[last])
    return done[np.maximum(i - 1, 0)] + np.where(i > 0, part, 0)


def idle_inside_pct(run, name: str):
    """Share of the slice's device-idle time (the gaps between its device
    intervals) that falls inside a ``name`` span."""
    s = readers.summary(run)
    sel = spans(run, (name,))
    if s is None or not sel:
        return None
    starts = np.array([k[1] for k in s["kernels"]], dtype=np.int64)
    ends = starts + np.array([k[2] for k in s["kernels"]], dtype=np.int64)
    gaps = np.array(_gaps(starts, ends), dtype=np.int64).reshape(-1, 2)
    idle = gaps[:, 1].sum()
    if idle <= 0:
        return None
    a0 = np.array([x["start_ns"] for x in sel], dtype=np.int64)
    a1 = np.array([x["end_ns"] for x in sel], dtype=np.int64)
    # the spans' union as disjoint sorted runs: the stretches between
    # the gaps ``_gaps`` finds among them
    g = np.array(_gaps(a0, a1), dtype=np.int64).reshape(-1, 2)
    u0 = np.concatenate(([a0.min()], g[:, 0] + g[:, 1]))
    u1 = np.concatenate((g[:, 0], [a1.max()]))
    inside = (covered_ns(u0, u1, gaps[:, 0] + gaps[:, 1])
              - covered_ns(u0, u1, gaps[:, 0]))
    return 100.0 * float(inside.sum()) / float(idle)
