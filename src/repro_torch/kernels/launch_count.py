"""The kernel wrappers' launch counters, kept meaning "launches run".

Each wrapper counts its launches in plain int attributes
(``xnor_matmul_vpu.launches``, ``flash_attention.launches_tc``, ...) that
``chip_smoke.py`` zeroes and reads. Two things would break that meaning:

* replica threads bumping one counter at once would lose increments, so
  every ``add`` takes one lock;
* a CUDA-graph capture runs each wrapper's Python once and launches
  nothing, and a replay launches every captured kernel again without
  running any wrapper. So while a thread captures (``recording``) its
  ``add``s go to that capture's tally instead of the counters, and
  ``add_all(tally)`` adds them back on every replay. The tally is per
  thread: another thread's launches during the capture count as usual.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_LOCK = threading.Lock()
_LOCAL = threading.local()


def add(fn, attr: str = "launches", n: int = 1) -> None:
    """Count ``n`` launches of wrapper ``fn`` in its ``attr`` counter, or
    in the current thread's capture tally while it records one."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is not None:
        tally[(fn, attr)] = tally.get((fn, attr), 0) + n
        return
    with _LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def add_all(tally: dict) -> None:
    """Count every launch of a captured tally (one graph replay)."""
    with _LOCK:
        for (fn, attr), n in tally.items():
            setattr(fn, attr, getattr(fn, attr) + n)


@contextmanager
def recording():
    """Inside: this thread's launches go to the yielded tally
    ``{(wrapper, counter name): launches}`` and not to the counters."""
    outer = getattr(_LOCAL, "tally", None)
    tally: dict = {}
    _LOCAL.tally = tally
    try:
        yield tally
    finally:
        _LOCAL.tally = outer
