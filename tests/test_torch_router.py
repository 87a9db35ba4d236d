"""The port's fleet router (``serve/router.py`` + ``serve/replica.py``) on
the CPU: the cases of the reference's ``tests/test_router.py`` on toy
torch forwards and on the full-width Table 2 BCNN, and a parity run
against the live reference router.

Deterministic scheduling runs in pump mode (``threaded=False``: no worker
threads, injected clocks): FIFO within a class, strict priority, EDF
within a rank, least-loaded dispatch, typed backpressure, the rolling
swap. The acceptance case drives mixed online + bulk Poisson traffic over
2 packed-BCNN replicas with a mid-drive rolling ``swap_packed``: every
request completes, each result equals the eager ``forward_packed`` of the
epoch that served it, and every replica's ``step_cache_size`` stays 1
(on the CPU the step is eager and counts input shapes; on the card it is
one CUDA graph: ``chip_smoke.py`` phase 5). A small threaded smoke runs
the real worker threads; its waits are bounded.

The parity case feeds one submit script, with one ``StepClock`` each,
to the reference ``Router`` over a swappable toy ``jnp`` forward and to
the port's over the same toy in torch: counters, completion order, and
each request's replica, epoch and logits agree.
"""
import time
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import BCNNEngine as JBCNNEngine
from repro.serve import Router as JRouter
from repro.serve import RouterOverload as JRouterOverload
from repro_torch.core import bcnn
from repro_torch.serve import (BCNNEngine, RequestClass, Router,
                               RouterOverload, RouterShutdown,
                               drive_mixed_poisson)
from repro_torch.serve.router import BULK


class StepClock:
    """Deterministic clock: advances ``dt`` seconds per call."""

    def __init__(self, dt: float = 1e-3):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def toy_forward(x):
    """(N, H, W, C) → (N, 2), row-separable so routing errors show up."""
    s = x.sum(dim=(1, 2, 3))
    return torch.stack([s, -s], dim=-1)


def toy_router(n_replicas=2, n_slots=2, clock=None, **kw):
    clock = clock or StepClock()
    engines = [BCNNEngine(toy_forward, n_slots=n_slots,
                          input_shape=(4, 4, 1), clock=clock, device="cpu")
               for _ in range(n_replicas)]
    return Router(engines, threaded=False, clock=clock, **kw)


def img(v, shape=(4, 4, 1)):
    return np.full(shape, v, np.float32)


@pytest.fixture(scope="module")
def packed_a():
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(0)))


@pytest.fixture(scope="module")
def packed_b():
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))


def _forward(packed, x):
    return bcnn.forward_packed(packed, torch.from_numpy(x),
                               path="xla").numpy()


# --------------------------------------------------------------- scheduling
def test_fifo_within_class_and_priority_across_classes():
    r = toy_router(n_replicas=1, n_slots=1, dispatch_depth=1)
    bulk = [r.submit(img(i), cls="bulk") for i in range(4)]
    online = [r.submit(img(10 + i), cls="online") for i in range(3)]
    r.run_until_idle()
    for i, q in enumerate(bulk):
        np.testing.assert_array_equal(q.logits, [16.0 * i, -16.0 * i])
    order = sorted(bulk + online, key=lambda q: q.t_dispatch)
    assert [q.rid for q in order] == [bulk[0].rid] + \
        [q.rid for q in online] + [q.rid for q in bulk[1:]]
    for group in (bulk, online):
        ts = [q.t_dispatch for q in group]
        assert ts == sorted(ts)


def test_edf_within_priority_rank():
    tight = RequestClass("tight", priority=0, deadline_s=0.1)
    loose = RequestClass("loose", priority=0, deadline_s=10.0)
    r = toy_router(n_replicas=1, n_slots=1, dispatch_depth=1,
                   classes=(tight, loose))
    r.submit(img(0), cls="loose")
    q_loose = [r.submit(img(i), cls="loose") for i in range(1, 3)]
    q_tight = [r.submit(img(9), cls="tight")]
    r.run_until_idle()
    order = sorted(q_loose + q_tight, key=lambda q: q.t_dispatch)
    assert order[0] is q_tight[0]


def test_least_loaded_dispatch_spreads_replicas():
    r = toy_router(n_replicas=2, n_slots=2)
    reqs = [r.submit(img(i)) for i in range(4)]
    assert [q.replica_id for q in reqs] == [0, 1, 0, 1]
    r.run_until_idle()
    assert all(q.done for q in reqs)
    assert all(rep.served == 2 for rep in r.replicas)


def test_backpressure_typed_rejection_and_atomic_batch():
    r = toy_router(n_replicas=1, n_slots=1, max_queue=4, dispatch_depth=0)
    for i in range(4):
        r.submit(img(i), cls="online")
    with pytest.raises(RouterOverload) as ei:
        r.submit(img(9), cls="online")
    assert ei.value.queue_depth == 4 and ei.value.max_queue == 4
    assert ei.value.cls_name == "online" and ei.value.n_requested == 1
    r2 = toy_router(n_replicas=1, n_slots=1, max_queue=4, dispatch_depth=0)
    r2.submit(img(0), cls="online")
    with pytest.raises(RouterOverload) as ei:
        r2.submit_batch([img(i) for i in range(4)], cls="bulk")
    assert ei.value.n_requested == 4
    assert r2.n_queued == 1
    assert len(r2.submit_batch([img(i) for i in range(3)], cls="bulk")) == 3
    assert r2.counters()["bulk"] == {"submitted": 3, "rejected": 4,
                                     "completed": 0, "shed": 0}


def test_unknown_class_rejected():
    r = toy_router(n_replicas=1)
    with pytest.raises(ValueError, match="unknown request class"):
        r.submit(img(0), cls="no-such-class")


def test_counters_ledger_zero_drop():
    r = toy_router(n_replicas=2, n_slots=2, max_queue=8, dispatch_depth=1)
    for i in range(10):
        try:
            r.submit(img(i), cls="online")
        except RouterOverload:
            pass
    c = r.counters()["online"]
    assert c["submitted"] == c["completed"] + r.pending
    r.run_until_idle()
    c = r.counters()["online"]
    assert c["completed"] == c["submitted"] and r.pending == 0


def test_stats_per_class_with_deadline_accounting():
    clock = StepClock(dt=1e-3)
    r = toy_router(n_replicas=1, n_slots=2, clock=clock,
                   classes=(RequestClass("online", 0, deadline_s=1e-6),
                            BULK))
    for i in range(3):
        r.submit(img(i), cls="online")
    r.submit(img(9), cls="bulk")
    r.run_until_idle()
    st = r.stats()
    assert st["online"]["n"] == 3 and st["bulk"]["n"] == 1
    assert st["online"]["deadline_miss_frac"] == 1.0
    assert "deadline_miss_frac" not in st["bulk"]
    assert st["online"]["rejected"] == 0


def test_classify_batch_no_threshold_cliff():
    r = toy_router(n_replicas=2, n_slots=2)
    for n in (3, 1):
        xs = np.stack([img(i + 1) for i in range(n)])
        out = r.classify_batch(xs, cls="bulk")
        assert out.shape == (n, 2)
        for i in range(n):
            np.testing.assert_array_equal(out[i],
                                          [16.0 * (i + 1), -16.0 * (i + 1)])


# ------------------------------------------------------------- rolling swap
def test_rolling_swap_mixed_poisson_zero_drops_bit_exact(packed_a,
                                                         packed_b):
    clock = StepClock(dt=2e-3)
    router = Router.from_packed(packed_a, n_replicas=2, n_slots=2,
                                path="xla", device="cpu", threaded=False,
                                clock=clock)
    n = 20
    images = np.random.default_rng(0).random((n, 32, 32, 3)).astype(
        np.float32)
    refs = {0: _forward(packed_a, images), 1: _forward(packed_b, images)}
    d = drive_mixed_poisson(router, images, rate_hz=100.0,
                            mix={"online": 3.0, "bulk": 1.0}, seed=1,
                            swap_to=packed_b, swap_at_frac=0.5)
    assert d["n_accepted"] == n and d["n_rejected"] == 0
    assert len(d["results"]) == n and router.pending == 0
    assert set(d["epochs"]) == {0, 1}, d["epochs"]
    assert d["epochs"][0] > 0 and d["epochs"][1] > 0
    for q in d["requests"]:
        np.testing.assert_array_equal(q.logits, refs[q.epoch][q.rid])
    for rep in router.replicas:
        assert rep.step_cache_size == 1, f"replica {rep.id}"
        assert rep.served > 0 and rep.epoch == 1


def test_rolling_swap_incompatible_leaves_fleet_serving(packed_a, packed_b):
    router = Router.from_packed(packed_a, n_replicas=2, n_slots=2,
                                path="xla", device="cpu", threaded=False,
                                clock=StepClock())
    images = np.random.default_rng(2).random((4, 32, 32, 3)).astype(
        np.float32)
    ref_a = _forward(packed_a, images)
    reqs = [router.submit(im) for im in images]
    with pytest.raises(ValueError, match="static"):
        router.rolling_swap(packed_b._replace(fc3_k=packed_b.fc3_k + 1))
    router.run_until_idle()
    for i, q in enumerate(reqs):
        assert q.done and q.epoch == 0
        np.testing.assert_array_equal(q.logits, ref_a[i])
    assert all(rep.epoch == 0 for rep in router.replicas)
    assert not router._paused


def test_rolling_swap_while_idle(packed_a, packed_b):
    router = Router.from_packed(packed_a, n_replicas=2, n_slots=2,
                                path="xla", device="cpu", threaded=False,
                                clock=StepClock())
    assert router.rolling_swap(packed_b) == 2
    assert all(rep.epoch == 1 for rep in router.replicas)
    x = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(router.classify_batch(x),
                                  _forward(packed_b, x))
    assert all(rep.step_cache_size == 1 for rep in router.replicas)


# ---------------------------------------------------------- shutdown/drain
def test_shutdown_drain_timeout_sheds_typed_threaded():
    engines = [BCNNEngine(toy_forward, n_slots=1, input_shape=(4, 4, 1),
                          device="cpu")]
    r = Router(engines, threaded=True, max_queue=8, dispatch_depth=0)
    reqs = [r.submit(img(i)) for i in range(4)]
    t0 = time.monotonic()
    r.shutdown(drain=True, timeout=0.3)
    assert time.monotonic() - t0 < 10.0
    for q in reqs:
        assert q.done and q.error is not None
        with pytest.raises(RouterShutdown):
            q.wait(timeout=1.0)
    assert r.counters()["online"] == {"submitted": 4, "rejected": 0,
                                      "completed": 0, "shed": 4}
    assert r.pending == 0
    with pytest.raises(RouterShutdown):
        r.submit(img(9))


def test_shutdown_wedged_pump_mode_sheds_not_hangs():
    r = toy_router(n_replicas=1, n_slots=1, max_queue=8, dispatch_depth=0)
    reqs = [r.submit(img(i)) for i in range(3)]
    r.shutdown(drain=True, timeout=1.0)
    assert all(q.done for q in reqs)
    assert r.counters()["online"]["shed"] == 3 and r.pending == 0


def test_shutdown_no_drain_sheds_queue_completes_inflight():
    r = toy_router(n_replicas=1, n_slots=1, dispatch_depth=1)
    reqs = [r.submit(img(i)) for i in range(3)]
    assert reqs[0].replica_id is not None
    r.shutdown(drain=False)
    assert reqs[0].done and reqs[0].error is None
    np.testing.assert_array_equal(reqs[0].logits, [0.0, 0.0])
    for q in reqs[1:]:
        assert q.done and isinstance(q.error, RouterShutdown)
    c = r.counters()["online"]
    assert c["completed"] == 1 and c["shed"] == 2 and r.pending == 0


# ----------------------------------------------------------- threaded smoke
def test_threaded_router_end_to_end(packed_a, packed_b):
    router = Router.from_packed(packed_a, n_replicas=2, n_slots=2,
                                path="xla", device="cpu", threaded=True)
    try:
        images = np.random.default_rng(4).random((12, 32, 32, 3)).astype(
            np.float32)
        refs = {0: _forward(packed_a, images), 1: _forward(packed_b, images)}
        d = drive_mixed_poisson(router, images, rate_hz=300.0,
                                mix={"online": 1.0, "bulk": 1.0}, seed=5,
                                swap_to=packed_b, swap_at_frac=0.5)
        assert d["n_accepted"] == 12 and d["n_rejected"] == 0
        assert len(d["results"]) == 12
        assert sum(d["epochs"].values()) == 12
        for q in d["requests"]:
            np.testing.assert_array_equal(q.logits, refs[q.epoch][q.rid])
        for rep in router.replicas:
            assert rep.step_cache_size == 1 and rep.epoch == 1
    finally:
        router.shutdown(timeout=30.0)
    assert all(not (rep._thread and rep._thread.is_alive())
               for rep in router.replicas_ever)


# ------------------------------------------------ parity with the reference
class JToyPacked(NamedTuple):
    fc3_w_words: jnp.ndarray          # (2, 1): the toy's weight


class TToyPacked(NamedTuple):
    fc3_w_words: torch.Tensor


class JToy:
    """A swappable toy forward for the reference engine (self-jitting
    kind: it has ``cache_size``)."""

    def __init__(self, w):
        self.packed = JToyPacked(jnp.asarray(w))

    def __call__(self, x):
        s = x.sum(axis=(1, 2, 3))[:, None]
        return s * self.packed.fc3_w_words[:, 0][None, :]

    def cache_size(self):
        return 1

    def swap(self, new):
        self.packed = new


class TToy:
    """The same toy in torch, with the port's in-place swap."""

    def __init__(self, w):
        self.packed = TToyPacked(torch.tensor(w))

    def __call__(self, x):
        s = x.sum(dim=(1, 2, 3))[:, None]
        return s * self.packed.fc3_w_words[:, 0][None, :]

    def cache_size(self):
        return 1

    def swap(self, new):
        bcnn.assert_swap_compatible(self.packed, new)
        self.packed.fc3_w_words.copy_(new.fc3_w_words)


W0 = [[1.0], [-1.0]]
W1 = [[2.0], [-3.0]]


def _script(router, overload, swap_to):
    """One submit script: singles of both classes, an atomic bulk batch,
    a shed batch, pumps, a rolling swap mid-way, a drain."""
    reqs, shed = [], 0
    for i in range(6):
        reqs.append(router.submit(img(i), cls="online" if i % 3 else "bulk"))
    router.pump()
    reqs += router.submit_batch([img(10 + i) for i in range(5)], cls="bulk")
    try:
        router.submit_batch([img(20 + i) for i in range(20)], cls="bulk")
    except overload:
        shed += 1
    router.pump()
    router.rolling_swap(swap_to)
    for i in range(4):
        reqs.append(router.submit(img(30 + i), cls="online"))
    router.run_until_idle()
    return reqs, shed


def test_router_parity_with_reference_pump_mode():
    kw = dict(threaded=False, max_queue=12, online_reserve=1, bulk_chunk=2)
    jclock, tclock = StepClock(), StepClock()
    jr = JRouter([JBCNNEngine(JToy(W0), n_slots=2, input_shape=(4, 4, 1),
                              clock=jclock) for _ in range(2)],
                 clock=jclock, **kw)
    tr = Router([BCNNEngine(TToy(W0), n_slots=2, input_shape=(4, 4, 1),
                            clock=tclock, device="cpu") for _ in range(2)],
                clock=tclock, **kw)
    jreqs, jshed = _script(jr, JRouterOverload, JToyPacked(jnp.asarray(W1)))
    treqs, tshed = _script(tr, RouterOverload, TToyPacked(torch.tensor(W1)))
    assert jshed == tshed == 1
    assert jr.counters() == tr.counters()
    assert len(jreqs) == len(treqs) == 13     # 6 + 3 chunks + 4
    for q, p in zip(jreqs, treqs):
        assert (q.rid, q.cls.name, q.replica_id, q.epoch) == \
            (p.rid, p.cls.name, p.replica_id, p.epoch)
        np.testing.assert_array_equal(np.asarray(q.logits), p.logits)
    order = [q.rid for q in sorted(jreqs, key=lambda q: (q.t_done, q.rid))]
    assert order == [p.rid for p in sorted(treqs,
                                           key=lambda p: (p.t_done, p.rid))]
    assert {q.epoch for q in jreqs} == {0, 1}
    assert [r.epoch for r in jr.replicas] == [r.epoch for r in tr.replicas]
    assert [r.served for r in jr.replicas] == [r.served
                                                for r in tr.replicas]
