"""Slot scheduler of the serving engine (a copy of ``repro/serve/slots.py``;
importing the reference's ``repro.serve`` would pull in JAX).

The paper's online-request scenario (§6.3, Fig. 7): a fixed set of slots
stepped continuously, FIFO admission the moment a slot frees — a request
never waits for a batch to fill, only for a free slot. The scheduler keeps
the request bookkeeping: monotone request ids and a FIFO queue, slot
occupancy and reuse, and per-request latency stamps (submit → admit →
done) for the p50/p95/p99 accounting.

Slot occupancy is host-side *data*, never tensor *shape*: the engine keeps
its device buffer at a fixed ``(n_slots, …)`` shape whatever the
occupancy. Pure host Python, no torch dependency.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np


@dataclass
class Request:
    """One queued / in-flight / finished request plus its latency stamps.

    Engine-agnostic: ``payload`` is the prompt token list for the LM engine
    and an image array for the BCNN engine; ``out`` accumulates whatever the
    engine produces (generated tokens; the BCNN engine returns logits out of
    band and leaves it empty). ``payload`` and ``frontend`` are dropped at
    completion, and the scheduler only retains the most recent ``history``
    finished requests, so a long-running service's memory stays bounded.
    """
    rid: int
    payload: Any
    max_new: int = 1
    frontend: Any = None            # e.g. audio frames / patch embeds
    out: list = field(default_factory=list)
    done: bool = False
    t_submit: float | None = None
    t_admit: float | None = None
    t_done: float | None = None

    @property
    def latency(self) -> float | None:
        """End-to-end seconds: submission to completion (queue + service).
        ``None`` until both stamps exist — a queued or in-flight request has
        no latency yet (the stamps used to default to 0.0, so an unfinished
        request silently reported a negative wall-clock offset)."""
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait(self) -> float | None:
        """Seconds spent waiting for a free slot before admission, or
        ``None`` while the request is still queued (not yet admitted)."""
        if self.t_admit is None or self.t_submit is None:
            return None
        return self.t_admit - self.t_submit


class SlotScheduler:
    """FIFO admission over a fixed set of slots.

    The scheduler owns the queue, the slot table, and the timing stamps; the
    engine owns the device state keyed by slot index (KV caches, image
    buffer) and calls back in three places:

        for i, req in sched.admit():   # fill engine state for slot i
        for i, req in sched.occupied():# step over live slots
        sched.complete(i)              # free slot i, stamp t_done

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.perf_counter``). ``history`` bounds how many finished requests
    are retained for latency accounting — older ones are evicted FIFO so a
    long-running service does not grow without bound.
    """

    def __init__(self, n_slots: int, *,
                 clock: Callable[[], float] = time.perf_counter,
                 history: int = 4096):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.slots: list[Request | None] = [None] * n_slots
        self.finished: deque[Request] = deque(maxlen=history)
        # deque, not list: admission pops from the head, and the deep
        # backlogs a fleet router builds up made list.pop(0) O(n²)
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self._clock = clock

    @property
    def clock(self) -> Callable[[], float]:
        """The scheduler's time source — drive loops must stamp arrivals
        with the SAME clock the latency stamps use (``drive_poisson``
        desynchronized from deterministic-clock tests before it did)."""
        return self._clock

    # ------------------------------------------------------------------ api
    def submit(self, payload, *, max_new: int = 1, frontend=None) -> int:
        """Enqueue a request; returns its rid. Admission happens at the next
        ``admit()`` call (the engine's step boundary), FIFO."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, payload, max_new=max_new,
                                   frontend=frontend,
                                   t_submit=self._clock()))
        return rid

    def admit(self) -> list[tuple[int, Request]]:
        """Move queued requests into free slots (FIFO) and stamp t_admit.
        Returns the newly admitted (slot_index, request) pairs so the engine
        can initialize per-slot device state."""
        admitted: list[tuple[int, Request]] = []
        for i, slot in enumerate(self.slots):
            if slot is None and self._queue:
                req = self._queue.popleft()
                req.t_admit = self._clock()
                self.slots[i] = req
                admitted.append((i, req))
        return admitted

    def occupied(self) -> list[tuple[int, Request]]:
        """The live (slot_index, request) pairs, in slot order."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def complete(self, slot: int) -> Request:
        """Finish the request in ``slot``: stamp t_done, free the slot (it is
        admittable again immediately), retain the request in ``finished``
        (bounded by ``history``; inputs are dropped, only stamps + out
        stay)."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        req.t_done = self._clock()
        req.done = True
        req.payload = None
        req.frontend = None
        self.slots[slot] = None
        self.finished.append(req)
        return req

    # ------------------------------------------------------------ introspect
    @property
    def n_occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def any_active(self) -> bool:
        """True while there is anything left to do (queued or in-flight)."""
        return bool(self._queue) or self.n_occupied > 0


def latency_stats(requests: Iterable[Request],
                  percentiles: tuple[int, ...] = (50, 95, 99)) -> dict:
    """Aggregate per-request latency + throughput over finished requests.

    Returns seconds-valued fields: ``p50``/``p95``/``p99`` (end-to-end
    latency percentiles), ``mean``/``max``, ``queue_p50`` (admission wait),
    and ``throughput`` = completed requests / wall span from first
    submission to last completion. A zero-length span (e.g. a single
    completed request: its submission IS the span's start and end to clock
    resolution) carries no rate information, so ``throughput`` is ``None``
    there — never ``inf``/``nan``, which are not JSON. Empty input →
    ``{"n": 0}``.

    Only fully stamped requests contribute: an unfinished request's
    ``latency``/``queue_wait`` are ``None`` (not a number), so queued or
    in-flight entries are filtered out rather than skewing the percentiles.
    """
    reqs = [r for r in requests
            if r.done and r.latency is not None and r.queue_wait is not None]
    if not reqs:
        return {"n": 0}
    lat = np.array([r.latency for r in reqs], np.float64)
    wait = np.array([r.queue_wait for r in reqs], np.float64)
    span = max(r.t_done for r in reqs) - min(r.t_submit for r in reqs)
    out = {"n": len(reqs),
           "mean": float(lat.mean()), "max": float(lat.max()),
           "queue_p50": float(np.percentile(wait, 50)),
           "throughput": float(len(reqs) / span) if span > 0 else None}
    for p in percentiles:
        out[f"p{p}"] = float(np.percentile(lat, p))
    return out
