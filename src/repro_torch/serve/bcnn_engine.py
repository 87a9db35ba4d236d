"""Streaming BCNN inference service — the paper's online-request scenario
— and its bulk route for the large-batch one (counterpart of
``repro/serve/bcnn_engine.py``).

The paper's headline result (§6.3, Fig. 7) is batch-size-insensitive
throughput for online individual requests. This engine serves the packed
deployment forward that way:

* a fixed set of ``n_slots`` image slots stepped continuously;
* FIFO admission (``serve/slots.py``) the moment a slot frees;
* one fixed-shape step: the slot buffer is always a ``(n_slots, 32, 32,
  3)`` float32 tensor on the engine's device, and occupancy is host data,
  so the step runs one CUDA graph on the card whatever the occupancy
  (``step_cache_size`` stays 1);
* every occupied slot completes at the end of its step (a BCNN request is
  one forward);
* per-request latency (submit → done) and throughput accounting
  (``serve/slots.py::latency_stats``);
* ``swap_packed``: weights hot-swapped under live traffic with no new
  capture, on every forward the engine owns.

The step's forward is the single-device ``core/bcnn.py::PackedForward``
or — with ``from_packed(pipeline_stages=N)`` — the stage-pipelined
``parallel/bcnn_pipeline.py::PipelinedForward``, the software form of
the paper's per-layer pipeline; the contracts above hold for both.

The paper's other Fig. 7 scenario — "static data in large batch sizes"
— is ``classify_batch``'s bulk route: with ``from_packed(data_shards=N)``
the engine also owns a batch-sharded data-parallel forward
(``parallel/bcnn_data_parallel.py::ShardedForward``), and a batch of at
least ``batch_threshold`` images bypasses the slots, while smaller ones
stream through them.

On the card each engine owns a ``torch.cuda.Stream`` (its
``PackedForward``'s, or a pooled one of its own for a pipelined step):
the slot copy, the step and the logits copy all run on it, and the
pipelined and bulk forwards order their own streams after it, so the
replicas of ``serve/router.py`` do not wait for one another's steps.

``from_packed`` builds the engine on the GPU unless ``device="cpu"`` is
passed; without a GPU it raises rather than serving on the CPU. With
``autotune=True`` it first measures a plan on that device
(``kernels/autotune.py::autotune_packed``); every forward of the engine
shares that one plan.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import bcnn
from repro_torch.core.execution_plan import build_plan, resolve_device
from repro_torch.kernels import streams
from repro_torch.serve.slots import SlotScheduler, latency_stats


class BCNNEngine:
    """Continuous streaming engine over a one-shot image classifier.

    ``forward_fn``: ``(n_slots, H, W, C) float32 tensor on device →
    (n_slots, n_classes) tensor``. A ``core/bcnn.py::PackedForward`` (from
    ``from_packed``) brings its stream, ``cache_size()`` and ``swap``; a
    ``PipelinedForward`` brings ``cache_size()`` and ``swap`` and runs
    after a stream of the engine's own; any other callable is opaque: it
    runs on a stream of the engine's own, ``step_cache_size`` counts the
    input shapes it was called at, and it cannot be hot-swapped.
    """

    def __init__(self, forward_fn: Callable, *, n_slots: int = 8,
                 input_shape: tuple[int, int, int] = (32, 32, 3),
                 clock: Callable[[], float] = time.perf_counter,
                 history: int = 4096, device="cuda"):
        self.n_slots = n_slots
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self.sched = SlotScheduler(n_slots, clock=clock, history=history)
        cuda = self.device.type == "cuda"
        self.stream = getattr(forward_fn, "stream", None) if cuda else None
        self._release = None
        if cuda and self.stream is None:
            self.stream = streams.acquire(self.device)
            self._release = weakref.finalize(self, streams.release,
                                             self.stream)
        # slots are filled on the host, then copied in one transfer
        self._x_host = torch.zeros((n_slots, *self.input_shape),
                                   dtype=torch.float32, pin_memory=cuda)
        self._x = (torch.zeros_like(self._x_host, device=self.device)
                   if cuda else self._x_host)
        self._step_fn = forward_fn
        self._shapes: set[tuple] = set()    # opaque forwards' input shapes
        self._steps = 0
        self._plan = None
        self._n_classes = None              # known for from_packed engines
        self._batch_fn = None               # from_packed(data_shards=N)
        self._batch_threshold = 0

    @classmethod
    def from_packed(cls, packed: bcnn.BCNNPacked, *, n_slots: int = 8,
                    path: str = "auto", conv_strategy: str | None = None,
                    conv_fusion: bool | None = None, plan=None,
                    autotune: bool = False, device="cuda",
                    pipeline_stages: int = 1,
                    pipeline_micro_batch: int = 1,
                    pipeline_devices=None,
                    data_shards: int = 0,
                    data_micro_batch: int = 8,
                    batch_threshold: int | None = None,
                    **kw) -> "BCNNEngine":
        """Engine over the packed deployment forward on ``device``. The
        per-knob kwargs build the ``ExecutionPlan`` unless ``plan`` is
        given ("auto" path: "mxu" on the GPU, "xla" on the CPU);
        ``autotune=True`` without a ``plan`` measures one on ``device``
        at the engine's batch of ``n_slots`` images.

        ``pipeline_stages > 1`` steps the slots through the stage-pipelined
        forward (``parallel/bcnn_pipeline.py::make_pipelined_forward``)
        instead of ``PackedForward``: the 9 layers cost-balanced onto
        ``pipeline_devices`` (None: every CUDA device, or the CPU for
        ``device="cpu"``) in ``pipeline_micro_batch`` granules.

        ``data_shards >= 1`` adds the bulk route of ``classify_batch``: a
        data-parallel forward
        (``parallel/bcnn_data_parallel.py::make_sharded_forward``, with
        ``n_stages=pipeline_stages``) over every CUDA device (the CPU
        ``data_shards`` times for ``device="cpu"``), taken by batches of
        at least ``batch_threshold`` images (default one chunk,
        ``data_shards × data_micro_batch``). 0 (the default) disables it.
        """
        device = resolve_device(device)
        if autotune and plan is None:
            from repro_torch.kernels.autotune import autotune_packed
            plan = autotune_packed(packed, device=device, batch=n_slots)
        if plan is None:
            plan = build_plan(packed, path=path, conv_strategy=conv_strategy,
                              conv_fusion=conv_fusion, device=device)
        cpu = device.type == "cpu"
        if pipeline_stages > 1:
            from repro_torch.parallel.bcnn_pipeline import \
                make_pipelined_forward
            if pipeline_devices is None and cpu:
                pipeline_devices = [device]
            fwd = make_pipelined_forward(
                packed, n_stages=pipeline_stages,
                micro_batch=pipeline_micro_batch, devices=pipeline_devices,
                plan=plan)
        else:
            fwd = bcnn.make_packed_forward(packed, plan=plan, device=device)
        eng = cls(fwd, n_slots=n_slots, device=fwd.device, **kw)
        eng._plan = plan
        eng._n_classes = packed.fc3_w_words.shape[0]
        if data_shards >= 1:
            from repro_torch.parallel.bcnn_data_parallel import \
                make_sharded_forward
            eng._batch_fn = make_sharded_forward(
                packed, data_shards=data_shards,
                micro_batch=data_micro_batch, n_stages=pipeline_stages,
                devices=[device] * data_shards if cpu else None, plan=plan)
            eng._batch_threshold = (eng._batch_fn.plan.chunk
                                    if batch_threshold is None
                                    else batch_threshold)
        return eng

    @property
    def clock(self) -> Callable[[], float]:
        """The engine's time source (the one its latency stamps use)."""
        return self.sched.clock

    @property
    def plan(self):
        """The ``core/execution_plan.py::ExecutionPlan`` every forward of
        the engine shares (slot step, pipeline stages, bulk route), or
        None for an opaque ``forward_fn``."""
        return self._plan

    @property
    def forward(self) -> Callable:
        """The step's forward (a ``core/bcnn.py::PackedForward`` or a
        ``parallel/bcnn_pipeline.py::PipelinedForward`` for
        ``from_packed`` engines)."""
        return self._step_fn

    def on_stream(self):
        """Context that makes the engine's device and stream current (a
        no-op on the CPU): ``serve/replica.py``'s worker thread steps
        inside it."""
        if self.stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.device))
        ctx.enter_context(torch.cuda.stream(self.stream))
        return ctx

    # ------------------------------------------------------------------ api
    def submit(self, image: np.ndarray) -> int:
        """Enqueue one image (H, W, C in [0, 1]); returns the request id."""
        img = np.asarray(image, np.float32)
        if img.shape != self.input_shape:
            raise ValueError(f"image shape {img.shape} != engine input "
                             f"shape {self.input_shape}")
        return self.sched.submit(img)

    def _forward(self) -> torch.Tensor:
        """The step's forward over the slot buffer (on the stream)."""
        if self._x is not self._x_host:
            self._x.copy_(self._x_host, non_blocking=True)
        if not hasattr(self._step_fn, "cache_size"):
            self._shapes.add((tuple(self._x.shape), self._x.dtype))
        return self._step_fn(self._x)

    def warmup(self) -> None:
        """Run the step once before timing-sensitive driving: on the card
        this captures the step's CUDA graph (and first builds and loads
        the kernel library)."""
        with self.on_stream():
            self._forward()
        if self.stream is not None:
            self.stream.synchronize()

    def step(self) -> dict[int, np.ndarray]:
        """One engine tick: admit from the queue, run the fixed-shape
        forward, complete every occupied slot. Returns {rid: logits}.

        Traced (``trace.py``) as ``engine.step`` (its number, and the first
        and last rid admitted: FIFO admission makes them contiguous) over
        ``engine.admit`` and ``_flush``'s spans. The flag is read once a
        step; off, the step runs no tracing code."""
        if trace.on():
            return self._step_traced()
        self._admit()
        return self._flush(False)

    def _admit(self) -> list:
        """The scheduler's FIFO admission, and the admitted images copied
        into their host slots."""
        admitted = self.sched.admit()
        for i, req in admitted:
            self._x_host[i] = torch.from_numpy(req.payload)
        return admitted

    def _step_traced(self) -> dict[int, np.ndarray]:
        with trace.span("engine.step", step=self._steps) as sp:
            with trace.span("engine.admit"):
                admitted = self._admit()
            if admitted:
                sp.set(first_rid=admitted[0][1].rid,
                       last_rid=admitted[-1][1].rid)
            return self._flush(True)

    def _flush(self, rec: bool | None = None) -> dict[int, np.ndarray]:
        """Run the forward over the slot buffer and complete every occupied
        slot (no admission — ``swap_packed`` uses this to drain in-flight
        requests on the pre-swap weights). Traced, where ``rec`` (read
        from ``trace.on()`` if None) says so, as ``engine.launch`` (the
        copy in, the replay and the copy of its output enqueued),
        ``engine.wait`` (the host blocked until the logits are back) and
        ``engine.complete``."""
        occupied = self.sched.n_occupied
        if occupied == 0:
            return {}
        if rec is None:
            rec = trace.on()
        with self.on_stream():
            if not rec:
                logits = self._forward().cpu().numpy()
            else:
                with trace.span("engine.launch"):
                    out = self._forward()
                with trace.span("engine.wait"):
                    logits = out.cpu().numpy()
        self._steps += 1
        if not rec:
            return self._complete(logits)
        trace.count("engine.steps", 1)
        trace.count("engine.slots_occupied", occupied)
        with trace.span("engine.complete"):
            return self._complete(logits)

    def _complete(self, logits: np.ndarray) -> dict[int, np.ndarray]:
        results = {}
        for i, req in self.sched.occupied():
            self.sched.complete(i)
            results[req.rid] = logits[i]
        return results

    def swap_packed(self, new_packed: bcnn.BCNNPacked
                    ) -> dict[int, np.ndarray]:
        """Hot-swap the served weights under live traffic, no new capture.

        * the replacement must be shape/static-identical to the served
          net (``core/bcnn.py::assert_swap_compatible``), checked against
          the step's forward and the bulk forward before anything moves:
          a rejected swap leaves the engine untouched;
        * slots occupied at swap time are drained first, on the pre-swap
          weights, and their logits returned ({} in the usual case: slots
          only stay occupied inside ``step``);
        * queued (not yet admitted) requests are served with the new
          weights;
        * every forward copies the new weights into its own in place, so
          ``step_cache_size`` and ``batch_cache_size`` stay where they
          were.

        An opaque ``forward_fn`` raises TypeError.
        """
        if not hasattr(self._step_fn, "swap"):
            raise TypeError(
                "this engine's forward does not support weight hot-swap; "
                "build it with BCNNEngine.from_packed (core/bcnn.py::"
                "PackedForward / the pipelined or data-parallel forwards)")
        bcnn.assert_swap_compatible(self._step_fn.packed, new_packed)
        if self._batch_fn is not None:
            bcnn.assert_swap_compatible(self._batch_fn.packed, new_packed)
        drained = self._flush()         # pre-swap weights, consistently
        with self.on_stream():
            self._step_fn.swap(new_packed)
            if self._batch_fn is not None:
                self._batch_fn.swap(new_packed)
        self._n_classes = new_packed.fc3_w_words.shape[0]
        return drained

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Drive until every submitted request completes. {rid: logits}."""
        results: dict[int, np.ndarray] = {}
        for _ in range(max_steps):
            if not self.sched.any_active:
                break
            results.update(self.step())
        return results

    def classify_batch(self, images: np.ndarray) -> np.ndarray:
        """A batch of images → (N, n_classes) logits, in input order.

        The paper's large-batch Fig. 7 scenario: a batch of at least
        ``batch_threshold`` images (on an engine built with
        ``from_packed(data_shards=...)``) bypasses the slots and runs
        through the data-parallel bulk forward, one capture per plan for
        any batch size. Smaller batches stream through the slots exactly
        like individually submitted requests. Both routes give bitwise
        equal logits. An empty batch is answered on the host: nothing
        runs.

        One caller drives the engine (as ``run``/``drive_poisson``): on
        the slot route, requests already queued by another caller are
        served alongside, but their logits are delivered to this loop and
        dropped."""
        images = np.asarray(images, np.float32)
        if images.ndim != 1 + len(self.input_shape) or \
                images.shape[1:] != self.input_shape:
            raise ValueError(f"batch shape {images.shape} != (N, "
                             f"{', '.join(map(str, self.input_shape))})")
        if len(images) == 0:
            return np.zeros((0, self._n_classes or 0), np.float32)
        if self._batch_fn is not None and \
                len(images) >= self._batch_threshold:
            with self.on_stream():
                return self._batch_fn(torch.from_numpy(images)).cpu().numpy()
        rids = [self.submit(img) for img in images]
        out = self.run()
        return np.stack([out[r] for r in rids])

    def close(self) -> None:
        """Free the forwards' graphs, weights and streams (the step's and
        the bulk route's) once the engine will not step again, as a
        retired replica's."""
        if hasattr(self._step_fn, "close"):
            self._step_fn.close()
        if self._batch_fn is not None:
            self._batch_fn.close()
        if self._release is not None:
            self._release()

    # ------------------------------------------------------------ accounting
    @property
    def steps_executed(self) -> int:
        return self._steps

    @property
    def batch_forward(self):
        """The bulk data-parallel forward
        (``parallel/bcnn_data_parallel.py::ShardedForward``; its ``plan``
        carries the shards / stages / micro-batch), or None when the
        engine was built without ``data_shards``."""
        return self._batch_fn

    @property
    def batch_threshold(self) -> int:
        """The smallest batch ``classify_batch`` sends to the bulk forward
        (0 when there is none)."""
        return self._batch_threshold

    @property
    def batch_cache_size(self) -> int:
        """Captures of the bulk forward (``ShardedForward.cache_size``): 0
        before its first use, then 1 whatever batch sizes
        ``classify_batch`` has seen."""
        return 0 if self._batch_fn is None else self._batch_fn.cache_size()

    @property
    def step_cache_size(self) -> int:
        """Captured graphs of the step (``PackedForward.cache_size``; for a
        pipelined step, the most any stage holds), or the input shapes an
        opaque forward was called at. The streaming contract: 1 across any
        occupancy pattern and any swap."""
        if hasattr(self._step_fn, "cache_size"):
            return int(self._step_fn.cache_size())
        return len(self._shapes)

    def stats(self, last_n: int | None = None) -> dict:
        """p50/p95/p99 latency + throughput over (the last_n) retained
        finished requests — see ``serve/slots.py::latency_stats``."""
        reqs = list(self.sched.finished)
        if last_n is not None:
            reqs = reqs[-last_n:]
        return latency_stats(reqs)


def drive_poisson(engine: BCNNEngine, images: np.ndarray, rate_hz: float,
                  *, seed: int = 0, warmup: bool = True) -> dict:
    """Offer ``images`` to the engine as a Poisson arrival process.

    Inter-arrival gaps are i.i.d. exponential with mean ``1/rate_hz``; the
    loop submits every request whose arrival time has passed, steps the
    engine while anything is live, and sleeps to the next arrival
    otherwise. Arrivals use the engine's clock. Returns ``{"results",
    "stats", "offered_hz"}`` covering exactly this drive's requests.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    n = len(images)
    if n > engine.sched.finished.maxlen:
        raise ValueError(
            f"drive of {n} requests exceeds the engine's finished-request "
            f"history ({engine.sched.finished.maxlen}); construct the "
            f"engine with history >= {n}")
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    if warmup:
        engine.warmup()
    clock = engine.clock
    real_time = clock is time.perf_counter   # sleeping only advances THIS
    my_rids: set[int] = set()
    results: dict[int, np.ndarray] = {}
    t0 = clock()
    nxt = 0
    while len(results) < n:
        now = clock() - t0
        while nxt < n and arrivals[nxt] <= now:
            my_rids.add(engine.submit(images[nxt]))
            nxt += 1
        if engine.sched.any_active:
            results.update((rid, logits)
                           for rid, logits in engine.step().items()
                           if rid in my_rids)
        elif nxt < n and real_time:
            time.sleep(max(0.0, min(arrivals[nxt] - now, 0.05)))
    mine = [r for r in engine.sched.finished if r.rid in my_rids]
    return {"results": results, "stats": latency_stats(mine),
            "offered_hz": float(rate_hz)}
