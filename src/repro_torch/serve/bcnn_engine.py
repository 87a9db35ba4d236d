"""Streaming BCNN inference service — the paper's online-request scenario
(counterpart of ``repro/serve/bcnn_engine.py``, single-device slot path).

The paper's headline result (§6.3, Fig. 7) is batch-size-insensitive
throughput for online individual requests. This engine serves the packed
deployment forward (``core/bcnn.py::make_packed_forward``) that way:

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
  capture; ``classify_batch``: a batch of images through the slots.

On the card each engine owns a ``torch.cuda.Stream`` (its forward's):
the slot copy, the graph replay and the logits copy all run on it, so the
replicas of ``serve/router.py`` do not wait for one another's steps.

``from_packed`` builds the engine on the GPU unless ``device="cpu"`` is
passed; without a GPU it raises rather than serving on the CPU. With
``autotune=True`` it first measures a plan on that device
(``kernels/autotune.py::autotune_packed``). The pipelined and
data-parallel forwards of the reference (and ``classify_batch``'s bulk
route through the latter) come with a later slice of the port.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bcnn
from repro_torch.core.execution_plan import resolve_device
from repro_torch.kernels import streams
from repro_torch.serve.slots import SlotScheduler, latency_stats


class BCNNEngine:
    """Continuous streaming engine over a one-shot image classifier.

    ``forward_fn``: ``(n_slots, H, W, C) float32 tensor on device →
    (n_slots, n_classes) tensor``. A ``core/bcnn.py::PackedForward`` (from
    ``from_packed``) brings its stream, ``cache_size()`` and ``swap``; any
    other callable is opaque: it runs on a stream of the engine's own,
    ``step_cache_size`` counts the input shapes it was called at, and it
    cannot be hot-swapped.
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

    @classmethod
    def from_packed(cls, packed: bcnn.BCNNPacked, *, n_slots: int = 8,
                    path: str = "auto", conv_strategy: str | None = None,
                    conv_fusion: bool | None = None, plan=None,
                    autotune: bool = False, device="cuda",
                    **kw) -> "BCNNEngine":
        """Engine over the packed deployment forward on ``device``. The
        per-knob kwargs build the ``ExecutionPlan`` unless ``plan`` is
        given ("auto" path: "mxu" on the GPU, "xla" on the CPU);
        ``autotune=True`` without a ``plan`` measures one on ``device``
        at the engine's batch of ``n_slots`` images."""
        if autotune and plan is None:
            from repro_torch.kernels.autotune import autotune_packed
            plan = autotune_packed(packed, device=device, batch=n_slots)
        fwd = bcnn.make_packed_forward(packed, path=path,
                                       conv_strategy=conv_strategy,
                                       conv_fusion=conv_fusion, plan=plan,
                                       device=device)
        eng = cls(fwd, n_slots=n_slots, device=fwd.device, **kw)
        eng._plan = fwd.plan
        eng._n_classes = packed.fc3_w_words.shape[0]
        return eng

    @property
    def clock(self) -> Callable[[], float]:
        """The engine's time source (the one its latency stamps use)."""
        return self.sched.clock

    @property
    def plan(self):
        """The ``core/execution_plan.py::ExecutionPlan`` of the step, or
        None for an opaque ``forward_fn``."""
        return self._plan

    @property
    def forward(self) -> Callable:
        """The step's forward (a ``core/bcnn.py::PackedForward`` for
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
        forward, complete every occupied slot. Returns {rid: logits}."""
        for i, req in self.sched.admit():
            self._x_host[i] = torch.from_numpy(req.payload)
        return self._flush()

    def _flush(self) -> dict[int, np.ndarray]:
        """Run the forward over the slot buffer and complete every occupied
        slot (no admission — ``swap_packed`` uses this to drain in-flight
        requests on the pre-swap weights)."""
        if self.sched.n_occupied == 0:
            return {}
        with self.on_stream():
            logits = self._forward().cpu().numpy()
        self._steps += 1
        results = {}
        for i, req in self.sched.occupied():
            self.sched.complete(i)
            results[req.rid] = logits[i]
        return results

    def swap_packed(self, new_packed: bcnn.BCNNPacked
                    ) -> dict[int, np.ndarray]:
        """Hot-swap the served weights under live traffic, no new capture.

        * the replacement must be shape/static-identical to the served
          net (``core/bcnn.py::assert_swap_compatible``), checked before
          anything moves: a rejected swap leaves the engine untouched;
        * slots occupied at swap time are drained first, on the pre-swap
          weights, and their logits returned ({} in the usual case: slots
          only stay occupied inside ``step``);
        * queued (not yet admitted) requests are served with the new
          weights;
        * the forward copies the new weights into its own in place
          (``PackedForward.swap``), so ``step_cache_size`` stays where it
          was.

        An opaque ``forward_fn`` raises TypeError.
        """
        if not hasattr(self._step_fn, "swap"):
            raise TypeError(
                "this engine's forward does not support weight hot-swap; "
                "build it with BCNNEngine.from_packed (core/bcnn.py::"
                "PackedForward)")
        bcnn.assert_swap_compatible(self._step_fn.packed, new_packed)
        drained = self._flush()         # pre-swap weights, consistently
        with self.on_stream():
            self._step_fn.swap(new_packed)
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
        """A batch of images → (N, n_classes) logits, in input order,
        streamed through the slots exactly like individually submitted
        requests (the reference's bulk data-parallel route comes with a
        later slice). An empty batch is answered on the host: no step
        runs.

        Single-driver contract (as ``run``/``drive_poisson``): requests
        already queued by another caller are served alongside, but their
        logits are delivered to this loop and dropped."""
        images = np.asarray(images, np.float32)
        if images.ndim != 1 + len(self.input_shape) or \
                images.shape[1:] != self.input_shape:
            raise ValueError(f"batch shape {images.shape} != (N, "
                             f"{', '.join(map(str, self.input_shape))})")
        if len(images) == 0:
            return np.zeros((0, self._n_classes or 0), np.float32)
        rids = [self.submit(img) for img in images]
        out = self.run()
        return np.stack([out[r] for r in rids])

    def close(self) -> None:
        """Free the forward's graphs, weights and stream
        (``PackedForward.close``) once the engine will not step again, as
        a retired replica's."""
        if hasattr(self._step_fn, "close"):
            self._step_fn.close()
        if self._release is not None:
            self._release()

    # ------------------------------------------------------------ accounting
    @property
    def steps_executed(self) -> int:
        return self._steps

    @property
    def step_cache_size(self) -> int:
        """Captured graphs of the step (``PackedForward.cache_size``), or
        the input shapes an opaque forward was called at. The streaming
        contract: 1 across any occupancy pattern and any swap."""
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
