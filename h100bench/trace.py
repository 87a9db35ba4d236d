"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` with CPU and
CUDA activity over a few steady seconds in the middle of the window, its
events kept in memory and reduced here to what the per-layer readers take:
device intervals by name, their union (busy time), the longest idle gaps
named by the host operation that was running, and the top device
operations. Nothing is written to disk."""
from __future__ import annotations

import time

import numpy as np
import torch

# device activities that are not work of the run's own
_NOT_WORK = ("Activity Buffer", "cudaDeviceSynchronize")
NAME_CHARS = 160        # of a name in the breakdown


class Tracer:
    """Profiles one slice of a timed loop. The loop calls ``tick(t)`` between
    iterations with seconds since the window opened; the slice starts at the
    first tick at or after ``start_s`` and stops at the first tick at or
    after ``start_s + length_s``, after a synchronize, so it holds whole
    iterations. ``active`` tells the loop whether the current iteration is
    inside the slice."""

    def __init__(self, enabled: bool, start_s: float, length_s: float):
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.active = False
        self.done = False
        self._prof = None
        self.t0 = self.t1 = None
        self._stop_at = None
        self.cost_s = 0.0      # the profiler's own start and stop
        self.summary: dict | None = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracing, which takes seconds."""
        if self.enabled:
            with self._profile():
                torch.cuda.synchronize()

    def tick(self, t: float) -> None:
        if not self.enabled or self.done:
            return
        if not self.active and t >= self.start_s:
            torch.cuda.synchronize()
            before = time.perf_counter()
            self._prof = self._profile()
            self._prof.__enter__()
            self.t0 = time.perf_counter()
            self.cost_s += self.t0 - before
            # the slice lasts length_s from when the profiler is running
            self._stop_at = t + (self.t0 - before) + self.length_s
            self.active = True
        elif self.active and t >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        """End the slice, if one is open; ``finish`` reduces its events
        once the window has closed."""
        if not self.active:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.cost_s += time.perf_counter() - self.t1
        self.active = False
        self.done = True

    def finish(self) -> None:
        """Reduce the slice's events (after the window)."""
        if self._prof is not None and self.done:
            self.summary = summarize(self._prof, self.t1 - self.t0)
            self._prof = None

    @property
    def seconds(self) -> float:
        return 0.0 if self.t0 is None or self.t1 is None else self.t1 - self.t0

    @property
    def taken_s(self) -> float:
        """Seconds of the window the slice took: its own length and the
        profiler's start and stop."""
        return self.seconds + self.cost_s


def _union_s(starts: np.ndarray, ends: np.ndarray) -> float:
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    # a new covered run starts where an interval begins after every
    # earlier one has ended
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    run_starts = s[idx]
    run_ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return float(np.sum(run_ends - run_starts)) / 1e9


def _gaps(starts: np.ndarray, ends: np.ndarray) -> list[tuple[float, float]]:
    """(start ns, length ns) of every idle gap between device intervals."""
    if len(starts) < 2:
        return []
    order = np.argsort(starts)
    s, e = starts[order], np.maximum.accumulate(ends[order])
    gap = s[1:] - e[:-1]
    keep = np.flatnonzero(gap > 0)
    return list(zip(e[:-1][keep].tolist(), gap[keep].tolist()))


def summarize(prof, window_s: float) -> dict:
    """Reduce a finished profile: ``kernels`` [(name, start ns, dur ns)] of
    device work (kernels, copies, fills), ``busy_s`` (their union),
    ``window_s``, ``device_ops`` (top 10 names by summed seconds) and
    ``idle_gaps`` (the 10 longest, named by the innermost host operation
    running when each began)."""
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if any(x in name for x in _NOT_WORK):
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((name, start, dur))
        elif dur > 0:
            cpu.append((name, start, start + dur))
    starts = np.array([d[1] for d in dev], dtype=np.int64)
    ends = starts + np.array([d[2] for d in dev], dtype=np.int64)
    by_name: dict[str, float] = {}
    for name, _, dur in dev:
        by_name[name[:NAME_CHARS]] = (by_name.get(name[:NAME_CHARS], 0.0)
                                      + dur / 1e9)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(_gaps(starts, ends), key=lambda g: -g[1])[:10]
    c_start = np.array([c[1] for c in cpu], dtype=np.int64)
    c_end = np.array([c[2] for c in cpu], dtype=np.int64)
    named = []
    for g0, glen in gaps:
        inside = np.flatnonzero((c_start <= g0) & (c_end > g0))
        host = (cpu[inside[np.argmax(c_start[inside])]][0] if len(inside)
                else "no host operation")
        named.append([host[:NAME_CHARS], glen / 1e9])
    # the device's clock and the host's are aligned by the profiler, not
    # equal: the window holds every device interval of the slice
    if len(dev):
        window_s = max(window_s, float(ends.max() - starts.min()) / 1e9)
    return {"kernels": dev, "busy_s": _union_s(starts, ends),
            "window_s": window_s,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def device_seconds(summary: dict, names=None, copies: bool | None = None
                   ) -> float:
    """Summed seconds of the slice's device intervals whose name holds one
    of ``names`` (all when None); ``copies`` True keeps only memory copies,
    False only the rest (kernels and fills)."""
    total = 0
    for name, _, dur in summary["kernels"]:
        is_copy = name.startswith("Memcpy")
        if copies is not None and is_copy != copies:
            continue
        if names is not None and not any(n in name for n in names):
            continue
        total += dur
    return total / 1e9
