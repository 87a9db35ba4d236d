"""Elastic fleet autoscaling — load-aware replica scale-up/scale-down
(counterpart of ``repro/serve/autoscale.py``).

The paper's headline claim (§6.3, Fig. 7) is that ONE accelerator serves
both "online individual requests in small batch sizes" and "static data in
large batch sizes" at the same throughput. The software fleet analogue has
two halves:

* **co-scheduling** (``serve/router.py``): bulk batches are split into
  micro-chunks admitted through the same priority/EDF scheduler as online
  traffic, with an ``online_reserve`` of per-replica capacity bulk may
  never occupy — so both regimes share replicas instead of a hard
  ``batch_threshold`` routing cliff;
* **elasticity** (this module): the replica count itself tracks offered
  load. ``FleetAutoscaler`` watches a sliding window of fleet *pressure*
  (outstanding work per slot) and per-class deadline misses, and walks the
  fleet between ``min_replicas`` and ``max_replicas`` through the router's
  scale mechanisms — ``Router.scale_up`` (spawn a fresh ``EngineReplica``
  from the CURRENT weight epoch's packed artifact, its step captured
  before it takes traffic) and ``Router.scale_down`` (pause → drain →
  retire: in-flight work always completes).

Hysteresis: scale up when the windowed mean pressure exceeds
``up_watermark``; scale down when it falls below ``down_watermark``;
``cooldown_s`` separates consecutive scale events. One exception outranks
both gates: a fleet below ``min_replicas`` (a replica worker died —
``serve/replica.py`` death detection) respawns immediately, cooldown or
not, because the floor is a capacity guarantee rather than a load
policy. ``AutoscaleConfig`` REQUIRES ``down_watermark < up_watermark /
2``, which makes oscillation on
a constant load impossible: after an up-scale at ``n`` replicas (pressure
``P/n > up``), the new pressure ``P/(n+1) > up·n/(n+1) ≥ up/2 > down``
cannot trigger the down-scale, and symmetrically for a down-scale at
``n ≥ 2``.

Determinism: the autoscaler is pure host Python over the router's
injectable clock. In pump mode (``threaded=False``) every
``Router.pump()`` runs exactly one ``step()`` — the soak tier
(tests/test_torch_soak.py) drives scale events with injected clocks and zero
threads. A threaded router runs ``step()`` on a controller thread every
``interval_s``.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class AutoscaleConfig:
    """Watermarks + limits for the fleet autoscaler.

    ``up_watermark``/``down_watermark`` are *pressure* thresholds —
    pressure = (queued + in-flight images) / total fleet slots, i.e. how
    many steps of work each slot has outstanding. ``window_s`` is the
    sliding-window span the pressure is averaged over; ``cooldown_s`` the
    minimum gap between scale events; ``interval_s`` the controller
    thread's sampling period (pump mode samples once per ``pump()``).
    ``miss_frac_hi`` (optional) adds a second up-trigger: scale up when
    the windowed deadline-miss fraction of deadline-carrying classes
    exceeds it, even at low pressure.
    """
    min_replicas: int = 1
    max_replicas: int = 4
    up_watermark: float = 2.0
    down_watermark: float = 0.25
    window_s: float = 0.5
    cooldown_s: float = 1.0
    interval_s: float = 0.02
    miss_frac_hi: float | None = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(f"max_replicas {self.max_replicas} < "
                             f"min_replicas {self.min_replicas}")
        if not 0 < self.down_watermark < self.up_watermark / 2:
            # the anti-oscillation hysteresis invariant (module docstring):
            # a ±1 replica change moves pressure by at most 2x, so the
            # watermarks must be more than 2x apart
            raise ValueError(
                f"need 0 < down_watermark < up_watermark/2 for "
                f"oscillation-free hysteresis, got down="
                f"{self.down_watermark}, up={self.up_watermark}")
        for name in ("window_s", "cooldown_s", "interval_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.miss_frac_hi is not None and not 0 < self.miss_frac_hi <= 1:
            raise ValueError(f"miss_frac_hi must be in (0, 1], "
                             f"got {self.miss_frac_hi}")


@dataclass(frozen=True)
class ScaleEvent:
    """One executed scale event (a point of the replica-count
    timeline)."""
    t: float                       # router-clock time of the decision
    direction: int                 # +1 (up) or -1 (down)
    n_replicas: int                # fleet size AFTER the event
    replica_id: int                # spawned (up) or retired (down) id
    pressure: float                # windowed mean pressure at decision


class FleetAutoscaler:
    """Sliding-window controller over ``Router.scale_up``/``scale_down``.

    ``step()`` = sample + decide + (maybe) execute; it is the ONLY entry
    point, so threaded and pump-mode routers share one code path. The
    router calls it — construct via ``Router.from_packed(autoscale=cfg)``
    rather than directly.
    """

    def __init__(self, router, config: AutoscaleConfig,
                 clock: Callable[[], float] | None = None):
        self.router = router
        self.config = config
        self.clock = clock if clock is not None else router.clock
        self._window: deque[tuple[float, float]] = deque()   # (t, pressure)
        self._last_event_t: float | None = None
        self._last_miss = (0, 0)       # (missed, total) at window start
        self.events: list[ScaleEvent] = []
        # sample→decide→execute must be atomic: a controller thread and a
        # caller stepping by hand (launch/serve_bcnn.py's burst path) may
        # otherwise both read n_replicas, both decide +1, and overshoot
        # max_replicas
        self._step_lock = threading.Lock()

    # ------------------------------------------------------------------ api
    def step(self, now: float | None = None) -> int:
        """One controller tick: sample the fleet, decide, execute. Returns
        the executed direction (+1 scale-up, -1 scale-down, 0 none)."""
        with self._step_lock:
            now = self.clock() if now is None else now
            snap = self.router.load_snapshot()
            pressure = (snap["outstanding"] / snap["total_slots"]
                        if snap["total_slots"] else 0.0)
            self._window.append((now, pressure))
            while (self._window
                   and self._window[0][0] < now - self.config.window_s):
                self._window.popleft()
            direction = self._decide(now, snap)
            if direction > 0:
                rep = self.router.scale_up()
                self._record(now, +1, rep.id)
            elif direction < 0:
                rid = self.router.scale_down()
                self._record(now, -1, rid)
            return direction

    @property
    def n_scale_ups(self) -> int:
        return sum(1 for e in self.events if e.direction > 0)

    @property
    def n_scale_downs(self) -> int:
        return sum(1 for e in self.events if e.direction < 0)

    def timeline(self, n_initial: int) -> list[tuple[float, int]]:
        """Replica-count timeline [(t, n_replicas)] starting from the
        seed fleet (t of the first sample, or 0.0 before any)."""
        t0 = self.events[0].t if self.events else 0.0
        out = [(min(t0, self._window[0][0]) if self._window else t0,
                n_initial)]
        out.extend((e.t, e.n_replicas) for e in self.events)
        return out

    # ------------------------------------------------------------- internals
    def windowed_pressure(self) -> float:
        if not self._window:
            return 0.0
        return sum(p for _, p in self._window) / len(self._window)

    def _windowed_miss_frac(self, snap: dict) -> float | None:
        missed, total = snap["deadline_missed"], snap["deadline_total"]
        m0, t0 = self._last_miss
        dm, dt = missed - m0, total - t0
        self._last_miss = (missed, total)
        return dm / dt if dt > 0 else None

    def _decide(self, now: float, snap: dict) -> int:
        miss = (self._windowed_miss_frac(snap)
                if self.config.miss_frac_hi is not None else None)
        # min_replicas is a FLOOR, not a watermark decision: a fleet that
        # lost a replica to a worker death (serve/replica.py death
        # detection) is under-capacity NOW, so the respawn bypasses both
        # the pressure window and the cooldown gate — the fault-injection
        # soak (tests/test_torch_soak.py) pins this path
        if snap["n_replicas"] < self.config.min_replicas:
            return +1
        if (self._last_event_t is not None
                and now - self._last_event_t < self.config.cooldown_s):
            return 0
        n = snap["n_replicas"]
        pressure = self.windowed_pressure()
        want_up = (pressure > self.config.up_watermark
                   or (miss is not None and miss > self.config.miss_frac_hi))
        if want_up and n < self.config.max_replicas:
            return +1
        # never retire a replica while work is outstanding beyond the
        # window's smoothing — the drain would just re-queue it elsewhere
        if (pressure < self.config.down_watermark
                and snap["queued"] == 0 and n > self.config.min_replicas):
            return -1
        return 0

    def _record(self, now: float, direction: int, replica_id: int) -> None:
        self._last_event_t = now
        self.events.append(ScaleEvent(
            t=now, direction=direction,
            n_replicas=self.router.n_replicas, replica_id=replica_id,
            pressure=self.windowed_pressure()))


def run_controller(autoscaler: FleetAutoscaler, stop_event,
                   interval_s: float) -> None:
    """Thread body for a threaded router's controller loop: one ``step()``
    per ``interval_s`` until ``stop_event`` is set. Scale execution happens
    on this thread (engine build + warmup included), so ``step()`` back-
    pressures the sampling naturally while a replica spawns."""
    while not stop_event.wait(interval_s):
        autoscaler.step()
