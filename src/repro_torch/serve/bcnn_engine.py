"""Streaming BCNN inference service — the paper's online-request scenario
(counterpart of ``repro/serve/bcnn_engine.py``, single-device slot path).

The paper's headline result (§6.3, Fig. 7) is batch-size-insensitive
throughput for online individual requests. This engine serves the packed
deployment forward (``core/bcnn.py::make_packed_forward``) that way:

* a fixed set of ``n_slots`` image slots stepped continuously;
* FIFO admission (``serve/slots.py``) the moment a slot frees;
* one fixed-shape step: the slot buffer is always a ``(n_slots, 32, 32,
  3)`` float32 tensor on the engine's device, and occupancy is host data,
  so every step runs the same kernels at the same shapes;
* every occupied slot completes at the end of its step (a BCNN request is
  one forward);
* per-request latency (submit → done) and throughput accounting
  (``serve/slots.py::latency_stats``).

``from_packed`` builds the engine on the GPU unless ``device="cpu"`` is
passed; without a GPU it raises rather than serving on the CPU. With
``autotune=True`` it first measures a plan on that device
(``kernels/autotune.py::autotune_packed``). The
fleet, pipeline, data-parallel and hot-swap paths of the reference come
with later slices of the port.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bcnn
from repro_torch.core.execution_plan import resolve_device
from repro_torch.serve.slots import SlotScheduler, latency_stats


class BCNNEngine:
    """Continuous streaming engine over a one-shot image classifier.

    ``forward_fn``: ``(n_slots, H, W, C) float32 tensor on device →
    (n_slots, n_classes) tensor``.
    """

    def __init__(self, forward_fn: Callable, *, n_slots: int = 8,
                 input_shape: tuple[int, int, int] = (32, 32, 3),
                 clock: Callable[[], float] = time.perf_counter,
                 history: int = 4096, device="cuda"):
        self.n_slots = n_slots
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self.sched = SlotScheduler(n_slots, clock=clock, history=history)
        self._x = torch.zeros((n_slots, *self.input_shape),
                              dtype=torch.float32, device=self.device)
        self._step_fn = forward_fn
        self._steps = 0
        self._plan = None

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

    # ------------------------------------------------------------------ api
    def submit(self, image: np.ndarray) -> int:
        """Enqueue one image (H, W, C in [0, 1]); returns the request id."""
        img = np.asarray(image, np.float32)
        if img.shape != self.input_shape:
            raise ValueError(f"image shape {img.shape} != engine input "
                             f"shape {self.input_shape}")
        return self.sched.submit(img)

    def warmup(self) -> None:
        """Run the step once before timing-sensitive driving (first-call
        costs: the kernel library build and load, allocator warm-up)."""
        self._step_fn(self._x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> dict[int, np.ndarray]:
        """One engine tick: admit from the queue, run the fixed-shape
        forward, complete every occupied slot. Returns {rid: logits}."""
        for i, req in self.sched.admit():
            self._x[i] = torch.from_numpy(req.payload)
        if self.sched.n_occupied == 0:
            return {}
        logits = self._step_fn(self._x).cpu().numpy()
        self._steps += 1
        results = {}
        for i, req in self.sched.occupied():
            self.sched.complete(i)
            results[req.rid] = logits[i]
        return results

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Drive until every submitted request completes. {rid: logits}."""
        results: dict[int, np.ndarray] = {}
        for _ in range(max_steps):
            if not self.sched.any_active:
                break
            results.update(self.step())
        return results

    # ------------------------------------------------------------ accounting
    @property
    def steps_executed(self) -> int:
        return self._steps

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
