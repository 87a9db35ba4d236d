"""Soak tier of the port's elastic fleet, deterministically (the cases of
the reference's ``tests/test_soak.py``, on the full-width Table 2 BCNN on
the CPU).

A ``slow``-marked pump-mode run of bursty mixed online + bulk traffic
over a packed-BCNN fleet with an active autoscaler, periodic alternating
rolling weight swaps and co-scheduled bulk chunks under an online
reserve: everything ``threaded=False`` with an injected ``StepClock``, so
a failure replays exactly. Every iteration must hold:

* **one captured step** — ``step_cache_size == 1`` on every replica that
  ever existed (on the CPU the step is eager and this counts input
  shapes; on the card it counts CUDA graphs, ``chip_smoke.py`` phase 5);
* **RSS per iteration** — after a warmup prefix, the resident-set growth
  averages near zero and stays under a hard bound. RSS is read after
  ``malloc_trim(0)``: glibc keeps the heap pages that the CPU path's
  multi-megabyte temporaries (im2col patches) freed, and how many it
  keeps varies from run to run by tens of megabytes; trimmed, RSS is what
  the process holds, and a retired replica that kept its weights shows
  as a step;
* **the request ledger** — submitted == completed + shed (+ 0 pending)
  per class; every request carries the logits of its stamped weight
  epoch's ``forward_packed``, exactly, or a typed ``RouterOverload``.

The fault-injection cases kill a replica worker mid-traffic (pump mode
and threaded): its orphans requeue, the autoscaler respawns to
``min_replicas``, and no request is lost.
"""
import ctypes
import ctypes.util
import time

import numpy as np
import pytest
import torch

from repro_torch.core import bcnn
from repro_torch.serve import AutoscaleConfig, Router, RouterOverload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, module fixtures included: the test workers
    share the CPUs, and torch's default of one thread per CPU each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


psutil = pytest.importorskip(
    "psutil", reason="RSS discipline needs psutil")


class StepClock:
    def __init__(self, dt: float = 1e-3):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


N_ITERS = 24
WARMUP_ITERS = 8            # allocator high-water settles here
SWAP_EVERY = 5
BURST = 32                  # images per iteration
POOL = 16                   # distinct images (requests cycle the pool)
RSS_MEAN_PER_ITER = 4 << 20          # bytes; post-warmup average bound
RSS_TOTAL = 192 << 20                # absolute post-warmup growth ceiling


def _rss_after_trim(proc) -> int:
    """Resident set after glibc hands its free heap pages back."""
    libc = ctypes.util.find_library("c")
    if libc:
        trim = getattr(ctypes.CDLL(libc), "malloc_trim", None)
        if trim is not None:
            trim(0)
    return proc.memory_info().rss


def _packed(seed):
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(seed)))


def _forward(packed, x):
    return bcnn.forward_packed(packed, torch.from_numpy(x),
                               path="xla").numpy()


@pytest.mark.slow
def test_soak_elastic_fleet_flat_caches_bounded_rss_closed_ledger():
    clock = StepClock(dt=1e-3)
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=2, up_watermark=2.0,
                          down_watermark=0.25, window_s=0.02,
                          cooldown_s=0.5, interval_s=0.001)
    packed = [_packed(k) for k in (0, 1)]
    router = Router.from_packed(packed[0], n_replicas=2, n_slots=2,
                                path="xla", device="cpu", threaded=False,
                                clock=clock, autoscale=cfg, max_queue=256,
                                online_reserve=1, bulk_chunk=2)
    rng = np.random.default_rng(11)
    pool = rng.random((POOL, 32, 32, 3)).astype(np.float32)
    refs = [_forward(p, pool) for p in packed]   # epoch e serves e % 2

    proc = psutil.Process()
    rss = []
    n_swaps = 0
    for it in range(N_ITERS):
        reqs = []                     # (pool index, request)
        for j in range(BURST):
            idx = (it * BURST + j) % POOL
            cls = "online" if (it + j) % 3 else "bulk"
            try:
                reqs.append((idx, router.submit(pool[idx], cls=cls)))
            except RouterOverload:
                pass                  # a typed reject is a closed outcome
        if it and it % SWAP_EVERY == 0:
            n_swaps += 1              # alternate a → b → a → … mid-backlog
            router.rolling_swap(packed[n_swaps % 2])
        router.run_until_idle()
        for _ in range(25):           # idle tail: the window drains, so
            router.pump()             # scale-downs happen
        for idx, q in reqs:
            assert q.done and q.error is None
            np.testing.assert_array_equal(q.logits, refs[q.epoch % 2][idx])
        assert router.pending == 0
        for name, c in router.counters().items():
            assert c["submitted"] == c["completed"] + c["shed"], (it, name, c)
        for rep in router.replicas_ever:
            assert rep.step_cache_size == 1, \
                f"iter {it}: replica {rep.id} captured again"
        rss.append(_rss_after_trim(proc))

    assert n_swaps >= 3 and router.fleet_epoch == n_swaps
    assert router.autoscaler.n_scale_ups >= 1
    assert router.autoscaler.n_scale_downs >= 1
    steady = rss[WARMUP_ITERS - 1:]
    deltas = np.diff(steady)
    mean_delta = float(deltas.mean()) if len(deltas) else 0.0
    assert mean_delta < RSS_MEAN_PER_ITER, \
        f"leaking {mean_delta / 1e6:.1f} MB/iteration (post-warmup)"
    assert steady[-1] - steady[0] < RSS_TOTAL, \
        f"grew {(steady[-1] - steady[0]) / 1e6:.1f} MB post-warmup"
    router.shutdown()


def test_fault_injection_replica_death_respawn_closed_ledger():
    clock = StepClock(dt=1e-3)
    packed = _packed(0)
    router = Router.from_packed(
        packed, n_replicas=2, n_slots=2, path="xla", device="cpu",
        threaded=False, clock=clock,
        # huge cooldown: only the min_replicas floor can explain a respawn
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=3,
                                  up_watermark=50.0, down_watermark=1.0,
                                  window_s=0.02, cooldown_s=1e9,
                                  interval_s=0.001))
    pool = np.random.default_rng(3).random((8, 32, 32, 3)).astype(
        np.float32)
    ref = _forward(packed, pool)

    reqs = [router.submit(im) for im in pool[:4]]
    router.pump()
    reqs += [router.submit(im) for im in pool[4:]]
    victim = router.replicas[0]
    victim.inject_fault()
    router.pump()                       # the worker dies mid-traffic here
    assert router.replica_deaths == 1 and not victim.alive
    assert isinstance(victim.death_error, RuntimeError)
    assert router.n_replicas == 1
    with pytest.raises(RuntimeError, match="dead"):
        victim.enqueue(reqs[0])

    router.run_until_idle()             # the survivor absorbs the orphans
    router.pump()                       # next tick: the floor respawns
    assert router.n_replicas == 2
    assert router.autoscaler.n_scale_ups == 1
    reqs += [router.submit(im) for im in pool]
    router.run_until_idle()

    assert all(r.done and r.error is None for r in reqs)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.logits, ref[i % len(pool)])
    c = router.counters()["online"]
    assert c["submitted"] == c["completed"] + c["shed"] == 16
    assert c["shed"] == 0 and router.pending == 0
    ever = router.replicas_ever
    assert victim in ever and len(ever) == 3
    assert all(rep.step_cache_size == 1 for rep in ever)
    router.shutdown()


def test_fault_injection_threaded_replica_death():
    packed = _packed(0)
    router = Router.from_packed(
        packed, n_replicas=2, n_slots=2, path="xla", device="cpu",
        threaded=True,
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=3,
                                  up_watermark=50.0, down_watermark=1.0,
                                  window_s=0.02, cooldown_s=1e9,
                                  interval_s=0.002))
    try:
        pool = np.random.default_rng(4).random((6, 32, 32, 3)).astype(
            np.float32)
        ref = _forward(packed, pool)
        for r in [router.submit(im) for im in pool]:
            r.wait(timeout=60.0)
        victim = router.replicas[0]
        victim.inject_fault()
        deadline = time.monotonic() + 30.0
        while router.replica_deaths < 1:
            assert time.monotonic() < deadline, "death never detected"
            time.sleep(0.002)
        while router.n_replicas < 2:
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.002)
        reqs = [router.submit(im) for im in pool]
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(r.wait(timeout=60.0), ref[i])
        assert not victim.alive
        c = router.counters()["online"]
        assert c["submitted"] == c["completed"] + c["shed"] == 12
        assert c["shed"] == 0
    finally:
        router.shutdown(timeout=30.0)
