"""The program's spans and counters, on the profiler's clock.

Off by default, and nearly free when off: ``span`` and ``count`` check one
flag and return the shared no-op ``NOOP`` or do nothing; no profiler object
is built and no clock is read. Recording is on while a ``torch.profiler``
session is active, or after ``enable()`` until ``disable()``.

* ``with span(name, device=False, **attrs) as sp:`` records the name, the
  start and end in Unix-epoch nanoseconds (``time.time_ns``: the clock of
  the profiler's host and device events, so spans lay directly over a
  profile's kernels), the enclosing span of the same thread, and the
  attributes (``sp.set(**attrs)`` adds some inside). While the profiler is
  active the span also opens a host range of its name in the profile (its
  twin), so the profile's timeline carries it. The twin is a
  ``_RecordFunctionFast``, not ``record_function``: the latter is a user
  annotation, which the profiler also lays over the device timeline as a
  range of its own, and readers of device intervals would count that
  range as device work. ``device=True`` also records a pair of pooled timing
  CUDA events on the current stream (none while the stream captures a
  graph); ``drain`` resolves them to the span's stream time in ms.
* ``count(name, n)`` adds an int, or a 0-d tensor that is summed on its
  device and read once, at ``drain``: counting never synchronises.
* ``drain()`` returns ``(spans, counters)`` and empties both; ``reset()``
  drops them. Spans are kept in memory, at most ``MAX_SPANS``; those past
  the bound are counted under ``trace.spans_lost``. Nothing is written to
  disk.

``kernels/launch_count.py`` stays the kernel wrappers' launch counter.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch

MAX_SPANS = 1 << 16

_profiling = torch.autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast

_enabled = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_spans: list = []           # _FIELDS values a finished span
_FIELDS = 7
_lost = 0
_counts: dict[str, int] = {}
_device_counts: dict[str, torch.Tensor] = {}
_events: list = []          # free timing events


def enable() -> None:
    """Record spans and counters until ``disable()``, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Undo ``enable()``; a profiler session still turns recording on."""
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans and counters are recorded now."""
    return _enabled or _profiling()


class _NoSpan:
    """The span returned while recording is off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "attrs", "start_ns", "marks",
                 "twin")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.attrs = name, attrs
        self.marks = device
        self.twin = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        # the span holds its profiler twin, and the twin its device marks
        self.start_ns = time.time_ns()
        if _profiling():
            self.twin = _host_range(self.name)
            self.twin.__enter__()
        if self.marks:
            self.marks = _mark_start()
        return self

    def __exit__(self, *exc):
        if self.marks:
            self.marks[1].record()
        if self.twin is not None:
            self.twin.__exit__(None, None, None)
            self.twin = None
        end_ns = time.time_ns()
        _local.stack.pop()
        global _lost
        with _lock:
            if len(_spans) < MAX_SPANS * _FIELDS:
                # flat, as values the garbage collector does not track:
                # tens of thousands of span objects kept alive made its
                # collections pause a traced serving loop for tens of ms
                _spans.extend((self.name, self.id, self.parent,
                               self.start_ns, end_ns, self.attrs or None,
                               self.marks or None))
            else:
                _lost += 1
                _free(self.marks)
        return False


def _mark_start():
    """(start, end) timing events, the start recorded on the current
    stream; None while that stream captures a graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    with _lock:
        pair = _events.pop() if _events else None
    if pair is None:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return pair


def _free(marks) -> None:
    """Return a span's timing events, if it has any, to the pool."""
    if marks:
        _events.append(marks)


def span(name: str, device: bool = False, **attrs):
    """A context manager that records one span while recording is on (see
    the module's docstring), else ``NOOP``. ``device``: also time it on the
    current CUDA stream."""
    if not (_enabled or _profiling()):
        return NOOP
    return _Span(name, device, attrs)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d tensor summed where it lives) to counter
    ``name`` while recording is on. A CUDA tensor counted while its stream
    captures a graph is left out."""
    if not (_enabled or _profiling()):
        return
    if isinstance(n, torch.Tensor):
        if n.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        n = n.detach()
        with _lock:
            acc = _device_counts.get(name)
            if acc is None:
                _device_counts[name] = n.to(torch.int64, copy=True)
            else:
                acc.add_(n)
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def drain() -> tuple[list[dict], dict[str, int]]:
    """Every span recorded since the last drain or reset, in the order they
    ended, as dicts (``name``, ``id``, ``parent``: the enclosing span's id
    or None, ``start_ns``, ``end_ns``, ``attrs``, ``device_ms``: the
    span's stream time, or None without device marks), and every counter;
    both are emptied."""
    global _spans, _counts, _device_counts, _lost
    with _lock:
        spans, counts, dev, lost = _spans, _counts, _device_counts, _lost
        _spans, _counts, _device_counts, _lost = [], {}, {}, 0
    out = []
    for i in range(0, len(spans), _FIELDS):
        name, id_, parent, start_ns, end_ns, attrs, marks = \
            spans[i:i + _FIELDS]
        ms = None
        if marks:
            marks[1].synchronize()
            ms = marks[0].elapsed_time(marks[1])
            with _lock:
                _free(marks)
        out.append({"name": name, "id": id_, "parent": parent,
                    "start_ns": start_ns, "end_ns": end_ns,
                    "attrs": attrs or {}, "device_ms": ms})
    for name, acc in dev.items():
        counts[name] = counts.get(name, 0) + int(acc.item())
    if lost:
        counts["trace.spans_lost"] = lost
    return out, counts


def reset() -> None:
    """Drop every recorded span and counter."""
    global _spans, _counts, _device_counts, _lost
    with _lock:
        for marks in _spans[_FIELDS - 1::_FIELDS]:
            _free(marks)
        _spans, _counts, _device_counts, _lost = [], {}, {}, 0
