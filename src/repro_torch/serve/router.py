"""Async request router over replicated BCNN engines — the fleet tier
(counterpart of ``repro/serve/router.py``).

The paper's headline claim (§6.3, Fig. 7) is batch-size-insensitive
throughput for *online individual requests*; one streaming ``BCNNEngine``
(``serve/bcnn_engine.py``) reproduces that discipline on one device, but
every serving path so far was a single synchronous driver over ONE engine.
This module scales the same discipline *across* engines — the
million-user tier the ROADMAP names:

* **bounded admission with backpressure** — the router queue holds at most
  ``max_queue`` undispatched images; past that, ``submit`` sheds load
  with a typed ``RouterOverload`` (callers see an explicit reject, never
  an unbounded queue or a silent drop);
* **SLO-aware scheduling, not pure FIFO** — requests carry a
  ``RequestClass`` (priority rank + optional latency deadline); the
  backlog is ordered by (priority, earliest-absolute-deadline, arrival),
  so latency-sensitive traffic overtakes bulk work while arrival order is
  preserved *within* a class (FIFO-within-class fairness,
  tests/test_torch_router.py);
* **least-loaded dispatch over N replicas** — each replica
  (``serve/replica.py``) steps its own ``BCNNEngine`` on its own thread;
  the router hands a request to the least-loaded live replica, capped at
  ``dispatch_depth`` in-flight images each so the backlog stays in the
  router where it can still be re-ordered and re-routed;
* **rolling weight swap** — ``rolling_swap`` walks the replica set one at
  a time: pause dispatch to a replica, let it drain, hot-swap
  (``BCNNEngine.swap_packed``, no new capture), resume. The rest of the
  fleet keeps serving, so a model update never drops traffic; every
  result is stamped with the weight *epoch* that produced it. The fleet's
  target epoch and packed artifact update FIRST, so a scale-up racing the
  swap spawns its replica on the post-swap weights and the walk skips it;
* **mixed-traffic co-scheduling** — ``submit_batch``/``classify_batch``
  split bulk offline work into multi-image micro-chunks admitted through
  the same priority/EDF scheduler instead of a separate
  ``batch_threshold`` device path, and ``online_reserve`` holds back a
  slice of every replica's ``dispatch_depth`` that bulk chunks may never
  occupy — online p99 is protected by the scheduler, not by a hard
  routing cliff (a reserve-blocked bulk chunk parks aside and lets the
  online traffic queued behind it flow);
* **elastic fleet** — ``scale_up`` spawns a fresh replica from the
  CURRENT weight epoch's packed artifact (its step captured as a CUDA
  graph before it takes traffic, while the others keep serving, so the
  one-capture-per-replica contract holds for every replica that ever
  existed); ``scale_down`` retires one via
  pause → drain → retire, never dropping in-flight work. Pass
  ``autoscale=`` (a ``serve/autoscale.py::AutoscaleConfig``) to let a
  ``serve/autoscale.py::FleetAutoscaler`` drive both between hysteresis
  watermarks — on a controller thread when ``threaded``, one step per
  ``pump()`` otherwise;
* **replica death containment** — a crashed worker
  (``serve/replica.py`` death detection, incl. ``inject_fault``) reports
  its orphaned requests through ``on_death``; the router retires the
  corpse, requeues every orphan at its original priority/deadline
  (``replica_deaths`` counts the events, the ledger never moves — no
  request is silently lost), and the autoscaler's ``min_replicas`` floor
  respawns capacity without waiting out the cooldown;
* **typed shedding on shutdown** — ``shutdown(drain=True)`` serves the
  backlog until its timeout, then sheds the remainder with a
  ``RouterShutdown`` (a ``RouterOverload``) raised from each victim's
  ``wait()``; the per-class ledger (``counters``) closes exactly:
  submitted == completed + shed + pending, with rejects tracked apart.

Deterministic tests use ``threaded=False``: no worker threads, the caller
``pump()``s the router (dispatch + every replica + one autoscaler step)
on one thread with an injected clock. The CLI (``launch/serve_bcnn.py
--replicas/--autoscale``) and ``chip_smoke.py``'s fleet phase run
``threaded=True``: each replica's worker thread steps its engine on the
engine's own CUDA stream.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.bcnn import assert_swap_compatible
from repro_torch.serve.autoscale import AutoscaleConfig, FleetAutoscaler, \
    run_controller
from repro_torch.serve.bcnn_engine import BCNNEngine
from repro_torch.serve.replica import EngineReplica
from repro_torch.serve.slots import latency_stats


@dataclass(frozen=True)
class RequestClass:
    """A traffic class: scheduling priority + optional latency SLO.

    ``priority`` ranks classes (lower = more urgent; strict — a queued
    higher-priority request always dispatches first). ``deadline_s`` is
    the per-request latency target: within a priority rank the backlog is
    served earliest-absolute-deadline first, and per-class stats report
    the fraction of finished requests that missed it. ``None`` means
    best-effort (no deadline ordering or accounting). ``bulk`` marks the
    class as offline batch work: its submissions may ride multi-image
    micro-chunks and are subject to the router's ``online_reserve``
    (capacity bulk may never take from latency-sensitive classes).
    """
    name: str
    priority: int = 0
    deadline_s: float | None = None
    bulk: bool = False


#: Default traffic classes: latency-sensitive online requests (the paper's
#: §6.3 individual-request scenario) and best-effort bulk/offline work.
ONLINE = RequestClass("online", priority=0, deadline_s=0.5)
BULK = RequestClass("bulk", priority=1, deadline_s=None, bulk=True)
DEFAULT_CLASSES = (ONLINE, BULK)


class RouterOverload(RuntimeError):
    """Typed backpressure signal: the admission queue is full and the
    request (or whole batch — batches admit atomically) was shed. Carries
    the queue state so callers can implement retry/defer policies."""

    def __init__(self, cls_name: str, queue_depth: int, max_queue: int,
                 n_requested: int = 1):
        self.cls_name = cls_name
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.n_requested = n_requested
        super().__init__(
            f"router queue full: {queue_depth}/{max_queue} queued, "
            f"cannot admit {n_requested} '{cls_name}' request(s)")


class RouterShutdown(RouterOverload):
    """The router shed an ALREADY-ADMITTED request at shutdown (drain
    timed out, or ``drain=False``). Raised from the victim's ``wait()``
    so callers distinguish "never ran" from "ran slow" — the same
    ``RouterOverload`` family as admission-time shedding."""

    def __init__(self, reason: str, n_shed: int = 0):
        self.cls_name = "*"
        self.queue_depth = 0
        self.max_queue = 0
        self.n_requested = n_shed
        self.reason = reason
        self.n_shed = n_shed
        RuntimeError.__init__(
            self, f"router shutdown: {reason} ({n_shed} queued request(s) "
                  f"shed)")


@dataclass(eq=False)
class RouterRequest:
    """One routed request: stamps, class, result, and provenance.

    Mirrors ``serve/slots.py::Request`` semantics — ``latency`` /
    ``queue_wait`` are ``None`` until the stamps exist, so
    ``serve/slots.py::latency_stats`` aggregates these directly.
    ``epoch``/``replica_id`` record which weight epoch on which replica
    produced ``logits`` (the rolling-swap bit-exactness evidence).
    ``image`` is a single ``(H, W, C)`` image or, for a co-scheduled bulk
    micro-chunk, a ``(k, H, W, C)`` stack (then ``logits`` is the
    matching ``(k, n_classes)``). A request shed at shutdown finishes
    with ``error`` set instead of ``logits``; ``wait()`` re-raises it.
    """
    rid: int
    cls: RequestClass
    image: Any = None               # dropped once the replica consumed it
    t_submit: float | None = None
    t_dispatch: float | None = None
    t_done: float | None = None
    logits: np.ndarray | None = None
    error: BaseException | None = None
    epoch: int | None = None
    replica_id: int | None = None
    done: bool = False
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)

    @property
    def latency(self) -> float | None:
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait(self) -> float | None:
        """Seconds in the router queue before dispatch to a replica."""
        if self.t_dispatch is None or self.t_submit is None:
            return None
        return self.t_dispatch - self.t_submit

    @property
    def deadline(self) -> float | None:
        """Absolute completion deadline on the router clock, or None."""
        if self.cls.deadline_s is None or self.t_submit is None:
            return None
        return self.t_submit + self.cls.deadline_s

    @property
    def deadline_missed(self) -> bool | None:
        """True/False once finished (None for no-deadline classes or
        unfinished requests)."""
        if self.deadline is None or self.latency is None:
            return None
        return self.t_done > self.deadline

    def wait(self, timeout: float | None = None) -> np.ndarray:
        """Block until served (threaded routers), then return the logits —
        or re-raise the typed shed error for a request the router gave up
        on at shutdown."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served in time")
        if self.error is not None:
            raise self.error
        return self.logits


def _n_images(image) -> int:
    """Images in a request payload: 1 for (H, W, C), k for (k, H, W, C)."""
    return 1 if image.ndim == 3 else int(image.shape[0])


class Router:
    """Admission + scheduling front-end over ``EngineReplica``s.

    ``engines`` may be heterogeneous in nothing that matters here: each
    must accept the same input shape. Build from a packed net with
    ``Router.from_packed`` — required for the elastic-fleet surface
    (``scale_up`` needs the packed artifact + an engine factory).
    ``dispatch_depth`` caps in-flight images per replica (default
    ``2 × n_slots``: one stepping batch + one queued behind it) — the
    rest of the backlog stays router-side where the SLO scheduler can
    still reorder it. ``online_reserve`` slots of that depth are never
    granted to ``bulk`` classes; ``bulk_chunk`` sets the default
    micro-chunk size for ``submit_batch`` (None = one request per image).
    """

    def __init__(self, engines: Sequence[BCNNEngine], *,
                 classes: Sequence[RequestClass] = DEFAULT_CLASSES,
                 max_queue: int = 256,
                 dispatch_depth: int | None = None,
                 online_reserve: int = 0,
                 bulk_chunk: int | None = None,
                 autoscale: AutoscaleConfig | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 history: int = 4096,
                 threaded: bool = True,
                 packed=None,
                 engine_factory: Callable[[Any], BCNNEngine] | None = None,
                 warm_on_scale: bool = True):
        if not engines:
            raise ValueError("need at least one engine")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.classes = tuple(classes)
        self._by_name = {c.name: c for c in classes}
        self.max_queue = max_queue
        self.threaded = threaded
        self.clock = clock
        self._depth = (dispatch_depth if dispatch_depth is not None
                       else 2 * max(e.n_slots for e in engines))
        if not 0 <= online_reserve < max(self._depth, 1):
            raise ValueError(
                f"online_reserve must be in [0, dispatch_depth="
                f"{self._depth}), got {online_reserve} — a reserve that "
                f"covers the whole depth starves bulk forever")
        if bulk_chunk is not None and bulk_chunk < 1:
            raise ValueError(f"bulk_chunk must be >= 1, got {bulk_chunk}")
        self._reserve = online_reserve
        self._bulk_chunk = bulk_chunk
        self._lock = threading.Lock()
        self._scale_lock = threading.RLock()   # serializes swap/scale walks
        self._heap: list[tuple[int, float, int, RouterRequest]] = []
        self._seq = 0
        self._next_rid = 0
        self._queued_images = 0
        self._paused: set[int] = set()
        self._stopped = False
        self._shutting_down = False
        self._submitted = {c.name: 0 for c in classes}
        self._rejected = {c.name: 0 for c in classes}
        self._completed = {c.name: 0 for c in classes}
        self._shed = {c.name: 0 for c in classes}
        self._deadline_missed = 0
        self._deadline_total = 0
        self._finished = {c.name: deque(maxlen=history) for c in classes}
        self._fleet_epoch = 0
        self._current_packed = packed
        self._make_engine = engine_factory
        self._warm_on_scale = warm_on_scale
        self._replica_deaths = 0
        self._replicas = [
            EngineReplica(e, replica_id=i, threaded=threaded,
                          on_done=self._on_done, on_death=self._on_death)
            for i, e in enumerate(engines)]
        self._next_replica_id = len(self._replicas)
        self._bulk_inflight = {r.id: 0 for r in self._replicas}
        self._retired: list[EngineReplica] = []
        self._autoscaler: FleetAutoscaler | None = None
        self._controller_thread: threading.Thread | None = None
        self._controller_stop: threading.Event | None = None
        if autoscale is not None:
            if self._make_engine is None:
                raise ValueError(
                    "autoscale needs an engine factory to spawn replicas; "
                    "build the router with Router.from_packed")
            self._autoscaler = FleetAutoscaler(self, autoscale)
            if threaded:
                self._controller_stop = threading.Event()
                self._controller_thread = threading.Thread(
                    target=run_controller,
                    args=(self._autoscaler, self._controller_stop,
                          autoscale.interval_s),
                    name="bcnn-autoscale", daemon=True)
                self._controller_thread.start()

    # ---------------------------------------------------------- construction
    @classmethod
    def from_packed(cls, packed, *, n_replicas: int = 2,
                    n_slots: int | None = None, path: str = "auto",
                    conv_strategy: str | None = None,
                    conv_fusion: bool | None = None,
                    plan=None, autotune: bool = False,
                    warmup: bool = True, device="cuda",
                    clock: Callable[[], float] = time.perf_counter,
                    history: int = 4096, **router_kw) -> "Router":
        """N independent ``BCNNEngine.from_packed`` replicas on ``device``
        behind one router. Each replica owns its forward, its weights and
        its stream (so each captures its step exactly once:
        ``step_cache_size == 1`` *per replica*); ``warmup`` captures them
        all before any traffic so the first requests don't pay N
        captures. ``conv_fusion`` threads to every replica's forward (the
        cross-layer fused K5 kernel — bit-exact, same contracts).
        The same factory is retained for ``scale_up``, so an elastically
        spawned replica is configured identically and built from the
        fleet's CURRENT packed artifact (post-swap if a rolling swap is
        in flight).

        ``plan`` / ``autotune``: one ``core/execution_plan.py::ExecutionPlan``
        for the WHOLE fleet. With ``autotune=True`` (and no explicit plan)
        the candidate space is measured exactly once on ``device``
        (``kernels/autotune.py::autotune_packed``) BEFORE the factory is
        captured — every initial replica, every ``scale_up`` spawn, and
        every rolling-swap rebuild reuses the same tuned plan; no replica
        ever re-measures."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        kw = {} if n_slots is None else {"n_slots": n_slots}
        if autotune and plan is None:
            from repro_torch.kernels.autotune import autotune_packed
            # tune once, at the served batch, and share it fleet-wide
            plan = autotune_packed(packed, device=device,
                                   batch=n_slots if n_slots else 8)
        if plan is None:
            from repro_torch.core import execution_plan as _xp
            plan = _xp.build_plan(packed, path=path,
                                  conv_strategy=conv_strategy,
                                  conv_fusion=conv_fusion, device=device)

        def make_engine(p):
            return BCNNEngine.from_packed(p, plan=plan, device=device,
                                          clock=clock, history=history, **kw)

        engines = [make_engine(packed) for _ in range(n_replicas)]
        if warmup:
            for e in engines:
                e.warmup()
        return cls(engines, clock=clock, history=history, packed=packed,
                   engine_factory=make_engine, warm_on_scale=warmup,
                   **router_kw)

    @property
    def replicas(self) -> tuple[EngineReplica, ...]:
        with self._lock:
            return tuple(self._replicas)

    @property
    def replicas_ever(self) -> tuple[EngineReplica, ...]:
        """Every replica that ever served: live + retired. The
        one-capture-per-replica contract is asserted over THIS set — a
        retired replica's captured step is part of the evidence."""
        with self._lock:
            return tuple(self._replicas) + tuple(self._retired)

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def fleet_epoch(self) -> int:
        """Target weight epoch: bumped at the START of each rolling swap
        (with ``_current_packed``), so concurrent scale-ups land on the
        new weights."""
        with self._lock:
            return self._fleet_epoch

    @property
    def autoscaler(self) -> FleetAutoscaler | None:
        return self._autoscaler

    @property
    def replica_deaths(self) -> int:
        """Worker deaths handled so far (orphans requeued, corpse retired
        into ``replicas_ever``). The fault-injection soak asserts this
        moved AND that the ledger still closed."""
        with self._lock:
            return self._replica_deaths

    @property
    def class_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    # ------------------------------------------------------------------ api
    def submit(self, image: np.ndarray,
               cls: RequestClass | str = "online") -> RouterRequest:
        """Admit one request (or shed it with ``RouterOverload``). Returns
        its ticket; ``.wait()`` for the logits on a threaded router."""
        return self._admit([np.asarray(image, np.float32)],
                           self._resolve_class(cls))[0]

    def submit_batch(self, images: Iterable[np.ndarray],
                     cls: RequestClass | str = "bulk",
                     chunk: int | None = None) -> list[RouterRequest]:
        """Admit a bulk batch ATOMICALLY: either the whole batch is queued
        (at the class's priority, co-scheduled with everything else) or it
        is shed with one ``RouterOverload`` — a half-admitted batch is
        useless to an offline caller. A ``bulk`` class's batch is split
        into ``chunk``-image micro-chunks (default: the router's
        ``bulk_chunk``; None = one request per image), each one scheduler
        entry — so a huge batch interleaves with online traffic at chunk
        granularity instead of monopolizing a replica. When
        ``online_reserve`` is set, chunks clamp to the per-replica bulk
        budget ``dispatch_depth - online_reserve`` so they stay
        dispatchable."""
        c = self._resolve_class(cls)
        arr = [np.asarray(im, np.float32) for im in images]
        if c.bulk:
            chunk = chunk if chunk is not None else self._bulk_chunk
            if chunk is not None and self._reserve > 0:
                chunk = max(1, min(chunk, self._depth - self._reserve))
            if chunk is not None and chunk > 1:
                flat = np.stack(arr) if arr else np.empty((0,))
                arr = [flat[i:i + chunk] for i in range(0, len(flat), chunk)]
        return self._admit(arr, c)

    def classify_batch(self, images: np.ndarray,
                       cls: RequestClass | str = "bulk",
                       chunk: int | None = None) -> np.ndarray:
        """Bulk convenience: ``submit_batch`` + gather, → (N, n_classes)
        logits in input order. There is no ``batch_threshold`` cliff (the
        reference's single-engine bulk route): the batch rides the
        scheduler at its class's priority, so
        co-arriving online traffic keeps its latency SLO while the batch
        soaks up the remaining fleet capacity."""
        reqs = self.submit_batch(np.asarray(images, np.float32), cls=cls,
                                 chunk=chunk)
        if not self.threaded:
            self.run_until_idle()
            outs = [r.logits for r in reqs]
        else:
            outs = [r.wait() for r in reqs]
        return np.concatenate([o if o.ndim == 2 else o[None] for o in outs])

    def scale_up(self) -> EngineReplica:
        """Spawn one replica from the fleet's CURRENT packed artifact:
        build via the retained ``from_packed`` factory, capture its step
        BEFORE it joins dispatch (one capture per replica, ever; the rest
        of the fleet keeps serving meanwhile), seed its
        weight epoch with the fleet's target epoch. Returns the new
        replica."""
        with self._scale_lock:
            if self._make_engine is None:
                raise RuntimeError(
                    "scale_up needs an engine factory; build the router "
                    "with Router.from_packed")
            if self._stopped:
                raise RuntimeError("router is shut down")
            engine = self._make_engine(self._current_packed)
            if self._warm_on_scale:
                engine.warmup()
            with self._lock:
                rid = self._next_replica_id
                self._next_replica_id += 1
                epoch = self._fleet_epoch
            rep = EngineReplica(engine, replica_id=rid,
                                threaded=self.threaded,
                                on_done=self._on_done,
                                on_death=self._on_death, epoch=epoch)
            with self._lock:
                self._replicas.append(rep)
                self._bulk_inflight[rep.id] = 0
        self._dispatch()
        return rep

    def scale_down(self, *, timeout: float = 60.0) -> int:
        """Retire one replica — least-loaded, newest on ties — by
        pause → drain → retire: dispatch stops feeding it, its in-flight
        work completes, then it leaves the live set (into ``replicas_ever``
        for the capture-contract audit) and its worker stops. Never drops
        a request. Returns the retired replica's id."""
        with self._scale_lock:
            with self._lock:
                if len(self._replicas) <= 1:
                    raise RuntimeError("cannot scale below 1 replica")
                rep = min(self._replicas, key=lambda r: (r.load, -r.id))
                self._paused.add(rep.id)
            try:
                self._dispatch()        # the rest of the fleet takes over
                self._drain_replica(rep, timeout)
            finally:
                with self._lock:
                    self._paused.discard(rep.id)
            with self._lock:
                self._replicas.remove(rep)
                self._bulk_inflight.pop(rep.id, None)
                self._retired.append(rep)
            rep.stop(timeout)
        self._dispatch()
        return rep.id

    def rolling_swap(self, new_packed, *, timeout: float = 60.0) -> int:
        """Hot-swap the fleet's weights one replica at a time, never
        dropping traffic: pause dispatch to replica i (the scheduler keeps
        feeding the others), wait for it to drain, swap on its idle engine
        (``BCNNEngine.swap_packed`` — no new capture), resume, move on.
        Returns the number of replicas swapped. An incompatible
        replacement is rejected upfront (``core/bcnn.py::
        assert_swap_compatible`` against the fleet's current artifact)
        before ANY fleet state changes, so a failed swap leaves the fleet
        consistent. The fleet's target epoch and packed artifact advance
        BEFORE the walk: a scale-up racing the swap spawns its replica on
        the post-swap weights, and the walk skips any replica already at
        (or past) the target epoch."""
        with self._scale_lock:
            if self._current_packed is not None:
                assert_swap_compatible(self._current_packed, new_packed)
            with self._lock:
                self._fleet_epoch += 1
                target = self._fleet_epoch
                if self._current_packed is not None:
                    self._current_packed = new_packed
                walk = list(self._replicas)
            swapped = 0
            for rep in walk:
                with self._lock:
                    skip = (rep not in self._replicas    # retired mid-walk
                            or rep.epoch >= target)      # spawned post-swap
                    if not skip:
                        self._paused.add(rep.id)
                if skip:
                    continue
                try:
                    self._dispatch()    # re-route its share of backlog
                    self._drain_replica(rep, timeout)
                    ticket = rep.request_swap(new_packed)
                    if not self.threaded:
                        rep.pump()
                    ticket.wait(timeout)
                    swapped += 1
                finally:
                    with self._lock:
                        self._paused.discard(rep.id)
                    self._dispatch()
            return swapped

    def pump(self) -> int:
        """Non-threaded mode: one deterministic scheduling round on the
        calling thread — one autoscaler step (if configured), dispatch the
        backlog, then let every live replica process its inbox. Returns
        completed request count."""
        if self.threaded:
            raise RuntimeError("pump() is for threaded=False routers; "
                               "threaded replicas run continuously")
        if self._autoscaler is not None and not self._shutting_down:
            self._autoscaler.step()
        self._dispatch()
        with self._lock:
            reps = list(self._replicas)
        return sum(rep.pump() for rep in reps)

    def run_until_idle(self, max_pumps: int = 100_000) -> int:
        """Non-threaded mode: pump until nothing is queued or in flight."""
        total = 0
        for _ in range(max_pumps):
            if not self.pending:
                return total
            total += self.pump()
        raise RuntimeError(f"router not idle after {max_pumps} pumps "
                           f"({self.pending} pending)")

    def shutdown(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the fleet. ``drain=True`` serves the backlog first, but
        BOUNDED: past ``timeout`` (e.g. a wedged replica under a deep
        backlog) the still-queued requests are shed with a typed
        ``RouterShutdown`` — their ``wait()`` raises instead of hanging,
        the ledger stays closed, and shutdown itself always terminates.
        ``drain=False`` sheds the queue immediately; work already inside a
        replica still completes (replicas finish their inbox on stop)."""
        self._shutting_down = True          # no scale events during teardown
        if self._controller_stop is not None:
            self._controller_stop.set()
            if self._controller_thread is not None:
                self._controller_thread.join(timeout)
        deadline = time.monotonic() + timeout
        if drain:
            if self.threaded:
                while self.pending and time.monotonic() < deadline:
                    self._dispatch()
                    time.sleep(0.001)
            else:
                while self.pending:
                    before = self.pending
                    if self.pump() == 0 and self.pending >= before:
                        break       # wedged (nothing moves): shed below
        self._shed_queue("drain timed out" if drain else "drain=False")
        with self._lock:
            self._stopped = True
            reps = list(self._replicas)
        for rep in reps:
            if not self.threaded:
                rep.pump()          # replicas finish their inbox on stop
            rep.stop(max(deadline - time.monotonic(), 0.1))

    # ------------------------------------------------------------ accounting
    @property
    def pending(self) -> int:
        """Undispatched + in-flight image count across the fleet."""
        with self._lock:
            queued = self._queued_images
            reps = list(self._replicas)
        return queued + sum(rep.load for rep in reps)

    @property
    def n_queued(self) -> int:
        """Undispatched scheduler entries (a bulk micro-chunk counts 1;
        see ``pending`` for image units)."""
        with self._lock:
            return len(self._heap)

    def load_snapshot(self) -> dict:
        """One consistent reading of fleet load — the autoscaler's sensor:
        queued/in-flight/outstanding images, live replica + slot counts,
        and the cumulative deadline ledger (missed/total finished requests
        of deadline-carrying classes) for windowed miss-fraction diffs."""
        with self._lock:
            queued = self._queued_images
            reps = list(self._replicas)
            missed, total = self._deadline_missed, self._deadline_total
        inflight = sum(r.load for r in reps)
        return {"queued": queued, "inflight": inflight,
                "outstanding": queued + inflight,
                "n_replicas": len(reps),
                "total_slots": sum(r.engine.n_slots for r in reps),
                "deadline_missed": missed, "deadline_total": total}

    def counters(self) -> dict:
        """Per-class admission ledger in image units. Closed exactly:
        submitted == completed + shed + pending, with ``rejected``
        (never admitted) tracked apart — the zero-drop bookkeeping the
        tests pin."""
        with self._lock:
            return {c.name: {"submitted": self._submitted[c.name],
                             "rejected": self._rejected[c.name],
                             "completed": self._completed[c.name],
                             "shed": self._shed[c.name]}
                    for c in self.classes}

    def stats(self, cls: RequestClass | str | None = None) -> dict:
        """Per-class latency percentiles (``serve/slots.py::latency_stats``
        over the retained finished history) + admission counters +
        ``deadline_miss_frac`` for deadline-carrying classes."""
        if cls is None:
            return {c.name: self.stats(c) for c in self.classes}
        c = self._resolve_class(cls)
        with self._lock:
            reqs = list(self._finished[c.name])
            rejected = self._rejected[c.name]
        st = latency_stats(reqs)
        st["rejected"] = rejected
        if c.deadline_s is not None and reqs:
            missed = [r.deadline_missed for r in reqs
                      if r.deadline_missed is not None]
            st["deadline_miss_frac"] = (sum(missed) / len(missed)
                                        if missed else None)
        return st

    # ------------------------------------------------------------- internals
    def _resolve_class(self, cls: RequestClass | str) -> RequestClass:
        if isinstance(cls, RequestClass):
            if cls.name not in self._by_name:
                raise ValueError(f"unknown request class {cls.name!r}; "
                                 f"router classes: {sorted(self._by_name)}")
            return cls
        try:
            return self._by_name[cls]
        except KeyError:
            raise ValueError(f"unknown request class {cls!r}; "
                             f"router classes: {sorted(self._by_name)}")

    def _admit(self, arrays: list, c: RequestClass) -> list[RouterRequest]:
        n_images = sum(_n_images(a) for a in arrays)
        with self._lock:
            if self._stopped:
                raise RouterShutdown("submit after shutdown")
            if self._queued_images + n_images > self.max_queue:
                self._rejected[c.name] += n_images
                raise RouterOverload(c.name, self._queued_images,
                                     self.max_queue, n_images)
            reqs = []
            now = self.clock()
            for image in arrays:
                req = RouterRequest(rid=self._next_rid, cls=c, image=image,
                                    t_submit=now)
                self._next_rid += 1
                # (priority, earliest-deadline, arrival seq): strict
                # priority first, EDF within a rank, FIFO within a class
                key = (c.priority,
                       now + c.deadline_s if c.deadline_s is not None
                       else float("inf"),
                       self._seq)
                self._seq += 1
                heapq.heappush(self._heap, (*key, req))
                self._queued_images += _n_images(image)
                self._submitted[c.name] += _n_images(image)
                reqs.append(req)
        self._dispatch()
        return reqs

    def _pick_replica(self, live: list, req: RouterRequest):
        """Least-loaded live replica with room for ``req`` — or None.
        Bulk work under a nonzero ``online_reserve`` additionally fits
        within the per-replica bulk budget ``depth - reserve``, so the
        reserve slots stay free for latency-sensitive classes."""
        k = _n_images(req.image)
        if req.cls.bulk and self._reserve > 0:
            budget = self._depth - self._reserve
            cands = [r for r in live if r.load < self._depth
                     and self._bulk_inflight.get(r.id, 0) + k <= budget]
        else:
            cands = [r for r in live if r.load < self._depth]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.load, r.id))

    def _dispatch(self) -> None:
        """Move backlog to replicas: least-loaded first, capped at
        ``dispatch_depth`` in-flight images per replica, paused replicas
        skipped (the rolling-swap/scale-down walks). A bulk entry blocked
        by the online reserve parks aside so higher-seq online entries
        still flow (later same-class entries park too — FIFO within the
        class survives); a blocked NON-bulk head stops dispatch (strict
        priority: nothing overtakes it). Safe from any thread."""
        while True:
            with self._lock:
                picked = None
                parked: list = []
                blocked: set[str] = set()
                while self._heap:
                    entry = heapq.heappop(self._heap)
                    req: RouterRequest = entry[-1]
                    if req.cls.bulk and req.cls.name in blocked:
                        parked.append(entry)
                        continue
                    live = [r for r in self._replicas
                            if r.id not in self._paused and r.alive]
                    rep = self._pick_replica(live, req) if live else None
                    if rep is None:
                        parked.append(entry)
                        if req.cls.bulk and live:
                            blocked.add(req.cls.name)
                            continue
                        break
                    picked = (rep, entry)
                    break
                for e in parked:
                    heapq.heappush(self._heap, e)
                if picked is None:
                    return
                rep, entry = picked
                req = entry[-1]
                k = _n_images(req.image)
                req.t_dispatch = self.clock()
                req.replica_id = rep.id
                self._queued_images -= k
                if req.cls.bulk:
                    self._bulk_inflight[rep.id] = (
                        self._bulk_inflight.get(rep.id, 0) + k)
            try:
                rep.enqueue(req)        # replica lock; never inside ours
            except RuntimeError:
                # replica retired between pick and enqueue: requeue intact
                with self._lock:
                    req.t_dispatch = None
                    req.replica_id = None
                    self._queued_images += k
                    if req.cls.bulk and rep.id in self._bulk_inflight:
                        self._bulk_inflight[rep.id] -= k
                    heapq.heappush(self._heap, entry)

    def _on_done(self, rep: EngineReplica, req: RouterRequest,
                 logits: np.ndarray, epoch: int) -> None:
        """Replica completion callback (runs on the replica's thread)."""
        k = 1 if logits.ndim == 1 else int(logits.shape[0])
        req.logits = logits
        req.epoch = epoch
        req.image = None
        req.t_done = self.clock()
        req.done = True
        with self._lock:
            self._completed[req.cls.name] += k
            self._finished[req.cls.name].append(req)
            if req.cls.bulk and rep.id in self._bulk_inflight:
                self._bulk_inflight[rep.id] -= k
            if req.cls.deadline_s is not None:
                self._deadline_total += 1
                if req.deadline_missed:
                    self._deadline_missed += 1
        req._event.set()
        self._dispatch()                # a slot's worth of capacity freed

    def _on_death(self, rep: EngineReplica, orphans: list) -> None:
        """Replica death callback (``serve/replica.py::EngineReplica._die``,
        runs on the dying worker's thread in threaded mode, on the pump
        caller otherwise): retire the corpse into ``replicas_ever``, then
        requeue every orphaned request at its original class priority with
        its ORIGINAL submit-time deadline — a re-run request is late by
        the wall time it already burned, not forgiven it. No ledger column
        moves (the request was neither completed nor shed; it is simply
        queued again), so submitted == completed + shed + pending keeps
        closing and the fault-injection soak can assert zero silent loss.
        The autoscaler notices the shrunken fleet via ``load_snapshot`` and
        respawns capacity (``min_replicas`` floor, cooldown-exempt)."""
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
                self._retired.append(rep)
                self._replica_deaths += 1
            self._paused.discard(rep.id)
            self._bulk_inflight.pop(rep.id, None)
            for req in orphans:
                if req.done:
                    continue            # defensive: finished ≠ orphan
                k = _n_images(req.image)
                req.t_dispatch = None
                req.replica_id = None
                key = (req.cls.priority,
                       req.t_submit + req.cls.deadline_s
                       if req.cls.deadline_s is not None else float("inf"),
                       self._seq)
                self._seq += 1
                heapq.heappush(self._heap, (*key, req))
                self._queued_images += k
        self._dispatch()                # survivors absorb the orphans

    def _shed_queue(self, reason: str) -> int:
        """Fail every still-queued request with a typed ``RouterShutdown``
        (counted in the ``shed`` ledger column; their ``wait()`` raises).
        Returns the number of requests shed."""
        with self._lock:
            victims = [e[-1] for e in self._heap]
            self._heap = []
            for req in victims:
                k = _n_images(req.image)
                self._queued_images -= k
                self._shed[req.cls.name] += k
        if not victims:
            return 0
        err = RouterShutdown(reason, n_shed=len(victims))
        for req in victims:
            req.error = err
            req.image = None
            req.done = True
            req._event.set()
        return len(victims)

    def _drain_replica(self, rep: EngineReplica, timeout: float) -> None:
        if not self.threaded:
            guard = 0
            while rep.load > 0:
                rep.pump()
                guard += 1
                if guard > 100_000:
                    raise RuntimeError(f"replica {rep.id} will not drain")
            return
        deadline = time.monotonic() + timeout
        while rep.load > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {rep.id} did not drain within {timeout}s "
                    f"({rep.load} in flight)")
            time.sleep(0.0005)


def drive_mixed_poisson(router: Router, images: np.ndarray, rate_hz: float,
                        *, mix: dict[str, float] | None = None,
                        seed: int = 0, swap_to=None,
                        swap_at_frac: float = 0.5) -> dict:
    """Offer a mixed-class Poisson stream to the router (the fleet-tier
    sibling of ``serve/bcnn_engine.py::drive_poisson``).

    Arrival gaps are i.i.d. exponential with mean ``1/rate_hz``; each
    arrival is assigned a traffic class by the ``mix`` weights (default:
    uniform over the router's classes). If ``swap_to`` is given, a rolling
    weight swap of the whole fleet is started when ``swap_at_frac`` of the
    arrivals are in — on a threaded router it runs concurrently with the
    traffic (the zero-drop demo), on a pump-mode router inline.

    Returns per-class stats scoped to THIS drive's requests:
    ``{"stats": {class: latency_stats + n_rejected}, "results",
    "requests", "offered_hz", "n_offered", "n_accepted", "n_rejected",
    "epochs"}``.
    ``epochs`` maps weight epoch → requests served by it (both non-zero
    across a mid-drive swap proves traffic spanned the update).
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    names = (sorted(mix) if mix is not None
             else [c.name for c in router.classes])
    weights = np.array([mix[n] for n in names] if mix is not None
                       else [1.0] * len(names), np.float64)
    if (weights < 0).any() or weights.sum() <= 0:
        raise ValueError(f"bad mix weights {mix}")
    n = len(images)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    chosen = rng.choice(len(names), size=n, p=weights / weights.sum())
    clock = router.clock
    real_time = clock is time.perf_counter
    accepted: list[RouterRequest] = []
    n_rejected = {nm: 0 for nm in names}
    swap_thread = None
    swap_started = False
    t0 = clock()
    for i in range(n):
        if swap_to is not None and not swap_started and i >= swap_at_frac * n:
            swap_started = True
            if router.threaded:
                swap_thread = threading.Thread(
                    target=router.rolling_swap, args=(swap_to,), daemon=True)
                swap_thread.start()
            else:
                router.rolling_swap(swap_to)
        while arrivals[i] > clock() - t0:
            if not router.threaded and router.pending:
                router.pump()           # serve while "waiting"
            elif real_time:
                # the clock moves between the test and this read: the
                # reference's sleep raises when it has just passed
                time.sleep(max(0.0, min(arrivals[i] - (clock() - t0),
                                        0.05)))
        try:
            accepted.append(router.submit(images[i], cls=names[chosen[i]]))
        except RouterOverload:
            n_rejected[names[chosen[i]]] += 1
    if swap_thread is not None:
        swap_thread.join(timeout=120.0)
        if swap_thread.is_alive():
            raise TimeoutError("rolling swap not done within 120 s")
    if router.threaded:
        for r in accepted:
            r.wait(timeout=120.0)
    else:
        router.run_until_idle()
    epochs: dict[int, int] = {}
    for r in accepted:
        epochs[r.epoch] = epochs.get(r.epoch, 0) + 1
    stats = {}
    for nm in names:
        st = latency_stats([r for r in accepted if r.cls.name == nm])
        st["n_rejected"] = n_rejected[nm]
        stats[nm] = st
    return {"results": {r.rid: r.logits for r in accepted},
            "requests": accepted,
            "stats": stats, "offered_hz": float(rate_hz),
            "n_offered": n, "n_accepted": len(accepted),
            "n_rejected": int(sum(n_rejected.values())), "epochs": epochs}
