"""The port's elastic fleet (``serve/autoscale.py`` + the router's scale
surface) on the CPU: the cases of the reference's
``tests/test_autoscale.py``.

Everything is pump mode (``threaded=False``, an injected ``StepClock``):
the autoscaler samples once per ``Router.pump()``, so a load step replays
tick by tick. The acceptance case drives a low → burst → idle mixed load
over a full-width packed-BCNN fleet with a mid-run rolling swap: the fleet
scales 1 → N → 1 with zero drops, each result equal to the eager
``forward_packed`` of its stamped weight epoch across scale and swap
boundaries, and ``step_cache_size == 1`` on every replica that ever
existed, retired ones included (on the card: one CUDA graph each,
``chip_smoke.py`` phase 5). The co-scheduling cases pin
``online_reserve``: a reserve-blocked bulk chunk parks aside and lets
online traffic queued behind it dispatch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bcnn
from repro_torch.serve import (AutoscaleConfig, BCNNEngine, RequestClass,
                               Router)


class StepClock:
    def __init__(self, dt: float = 1e-3):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def toy_forward(x):
    s = x.sum(dim=(1, 2, 3))
    return torch.stack([s, -s], dim=-1)


def toy_router(n_replicas=1, n_slots=2, clock=None, **kw):
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


def packed_router(packed, clock, *, n_replicas=1, autoscale=None, **kw):
    return Router.from_packed(packed, n_replicas=n_replicas, n_slots=2,
                              path="xla", device="cpu", threaded=False,
                              clock=clock, autoscale=autoscale, **kw)


# --------------------------------------------------------------- the config
def test_config_validates_hysteresis_and_bounds():
    AutoscaleConfig()
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscaleConfig(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        AutoscaleConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscaleConfig(up_watermark=2.0, down_watermark=1.0)
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscaleConfig(up_watermark=2.0, down_watermark=0.0)
    with pytest.raises(ValueError, match="window_s"):
        AutoscaleConfig(window_s=0.0)
    with pytest.raises(ValueError, match="miss_frac_hi"):
        AutoscaleConfig(miss_frac_hi=1.5)


def test_autoscale_requires_engine_factory():
    with pytest.raises(ValueError, match="factory"):
        toy_router(autoscale=AutoscaleConfig())


# ------------------------------------------------------------- scale up/down
def test_scale_up_spawns_warm_identical_replica(packed_a):
    router = packed_router(packed_a, StepClock())
    assert router.n_replicas == 1
    rep = router.scale_up()
    assert router.n_replicas == 2 and rep.id == 1
    assert rep.step_cache_size == 1          # warmed before taking traffic
    x = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(router.classify_batch(x),
                                  _forward(packed_a, x))
    assert all(r.step_cache_size == 1 for r in router.replicas_ever)


def test_scale_down_drains_never_drops(packed_a):
    router = packed_router(packed_a, StepClock(), n_replicas=2)
    x = np.random.default_rng(1).random((6, 32, 32, 3)).astype(np.float32)
    reqs = [router.submit(im) for im in x]
    rid = router.scale_down()
    assert router.n_replicas == 1
    router.run_until_idle()
    assert all(q.done and q.error is None for q in reqs)
    retired = [r for r in router.replicas_ever if r.id == rid]
    assert len(retired) == 1 and retired[0].load == 0
    assert retired[0].step_cache_size == 1
    with pytest.raises(RuntimeError, match="closed"):
        retired[0].engine.forward(torch.zeros(2, 32, 32, 3))
    with pytest.raises(RuntimeError, match="below 1"):
        router.scale_down()


def test_autoscaler_scales_up_under_pressure_and_back_down(packed_a):
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=2, up_watermark=2.0,
                          down_watermark=0.25, window_s=0.004,
                          cooldown_s=0.05, interval_s=0.001)
    router = packed_router(packed_a, StepClock(dt=1e-3), autoscale=cfg,
                           max_queue=512)
    x = np.random.default_rng(2).random((16, 32, 32, 3)).astype(np.float32)
    reqs = [router.submit(im) for im in x]
    router.run_until_idle()
    assert router.autoscaler.n_scale_ups == 1
    assert router.n_replicas == 2
    for _ in range(400):
        router.pump()
    assert router.autoscaler.n_scale_downs == 1
    assert router.n_replicas == 1
    assert all(q.done and q.error is None for q in reqs)
    assert all(r.step_cache_size == 1 for r in router.replicas_ever)
    assert [n for _, n in router.autoscaler.timeline(1)] == [1, 2, 1]


# --------------------------------------------------------- swap ↔ scale race
def test_scale_up_racing_rolling_swap_lands_on_post_swap_epoch(
        packed_a, packed_b, monkeypatch):
    router = packed_router(packed_a, StepClock(), n_replicas=2)
    spawned = []
    orig = router._drain_replica

    def drain_then_spawn(rep, timeout):
        orig(rep, timeout)
        if not spawned:
            spawned.append(router.scale_up())
    monkeypatch.setattr(router, "_drain_replica", drain_then_spawn)
    assert router.rolling_swap(packed_b) == 2
    new = spawned[0]
    assert router.fleet_epoch == 1 and new.epoch == 1
    assert all(r.epoch == 1 for r in router.replicas)
    x = np.random.default_rng(3).random((3, 32, 32, 3)).astype(np.float32)
    ref_b = _forward(packed_b, x)
    for im, ref in zip(x, ref_b):
        for _ in range(3):
            q = router.submit(im)
            router.run_until_idle()
            np.testing.assert_array_equal(q.logits, ref)
    assert all(r.step_cache_size == 1 for r in router.replicas_ever)


def test_swap_after_scale_up_swaps_everyone(packed_a, packed_b):
    router = packed_router(packed_a, StepClock())
    router.scale_up()
    assert router.rolling_swap(packed_b) == 2
    assert all(r.epoch == 1 for r in router.replicas)


# ------------------------------------------------------------- co-scheduling
def test_reserve_blocked_bulk_parks_and_online_flows():
    on = RequestClass("on", priority=0)
    bk = RequestClass("bk", priority=0, bulk=True)
    r = toy_router(n_slots=2, dispatch_depth=2, online_reserve=1,
                   classes=(on, bk))
    b = r.submit_batch([img(1), img(2)], cls="bk")
    assert b[0].replica_id is not None
    assert b[1].replica_id is None
    o = r.submit(img(3), cls="on")
    assert o.replica_id is not None
    r.run_until_idle()
    assert all(q.done for q in b) and o.done
    np.testing.assert_array_equal(o.logits, [48.0, -48.0])


def test_bulk_chunking_splits_and_reassembles_bit_exact():
    r = toy_router(n_slots=2, dispatch_depth=4, bulk_chunk=2)
    xs = np.stack([img(i + 1) for i in range(5)])
    reqs = r.submit_batch(xs, cls="bulk")
    assert [q.image.shape[0] for q in reqs] == [2, 2, 1]
    out = r.classify_batch(xs, cls="bulk")
    assert out.shape == (5, 2)
    for i in range(5):
        np.testing.assert_array_equal(out[i], [16.0 * (i + 1),
                                               -16.0 * (i + 1)])
    c = r.counters()["bulk"]
    assert c["submitted"] == 10 and c["completed"] == 10


def test_chunk_clamps_to_bulk_budget_under_reserve():
    r = toy_router(n_slots=2, dispatch_depth=4, online_reserve=1)
    reqs = r.submit_batch(np.stack([img(i) for i in range(6)]),
                          cls="bulk", chunk=64)
    assert [q.image.shape[0] for q in reqs] == [3, 3]
    r.run_until_idle()
    assert all(q.done for q in reqs)


def test_monopoly_chunk_without_reserve_still_serves():
    r = toy_router(n_slots=2, dispatch_depth=4, online_reserve=0)
    out = r.classify_batch(np.stack([img(i + 1) for i in range(8)]),
                           cls="bulk", chunk=8)
    assert out.shape == (8, 2)
    np.testing.assert_array_equal(out[:, 0], 16.0 * np.arange(1, 9))


# ---------------------------------------------------- the acceptance case
def test_load_step_acceptance_one_to_n_to_one(packed_a, packed_b):
    clock = StepClock(dt=1e-3)
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=3, up_watermark=2.0,
                          down_watermark=0.25, window_s=0.004,
                          cooldown_s=0.03, interval_s=0.001)
    router = packed_router(packed_a, clock, autoscale=cfg, max_queue=512,
                           online_reserve=1, bulk_chunk=2)
    n = 28
    images = np.random.default_rng(7).random((n, 32, 32, 3)).astype(
        np.float32)
    ref = {0: _forward(packed_a, images), 1: _forward(packed_b, images)}
    online = []
    for i in range(4):
        online.append((i, router.submit(images[i], cls="online")))
        router.pump()
    assert router.n_replicas == 1
    for i in range(4, 20):
        online.append((i, router.submit(images[i], cls="online")))
    bulk_idx = list(range(20, n))
    bulk_reqs = router.submit_batch(images[20:], cls="bulk")
    router.rolling_swap(packed_b)
    router.run_until_idle()
    assert router.autoscaler.n_scale_ups >= 1
    assert max(e.n_replicas for e in router.autoscaler.events) >= 2
    for _ in range(600):
        router.pump()
    assert router.n_replicas == 1
    assert router.autoscaler.n_scale_downs == router.autoscaler.n_scale_ups
    for i, q in online:
        assert q.done and q.error is None
        np.testing.assert_array_equal(q.logits, ref[q.epoch][i])
    off = 0
    for q in bulk_reqs:
        assert q.done and q.error is None
        rows = q.logits if q.logits.ndim == 2 else q.logits[None]
        for j in range(len(rows)):
            np.testing.assert_array_equal(rows[j],
                                          ref[q.epoch][bulk_idx[off + j]])
        off += len(rows)
    c = router.counters()
    assert sum(v["submitted"] for v in c.values()) == n
    assert sum(v["completed"] for v in c.values()) == n
    assert sum(v["shed"] for v in c.values()) == 0
    assert len(router.replicas_ever) >= 3
    for rep in router.replicas_ever:
        assert rep.step_cache_size == 1, f"replica {rep.id}"
    assert all(r.epoch == router.fleet_epoch for r in router.replicas)
