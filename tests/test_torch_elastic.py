"""The port's elastic shard assignment (``repro_torch/train/elastic.py``)
against the reference's (``repro/train/elastic.py``): the cases of
``tests/test_elastic.py`` (determinism, balance, minimal movement,
straggler work stealing; without ``hypothesis``, a seeded sweep of
(shards, hosts) in place of its property test), and equal outputs over
a seeded sweep. Pure Python on both sides, so equal means equal."""
import numpy as np
import pytest

from repro.train import elastic as jelastic
from repro_torch.train import elastic

SWEEP = np.random.default_rng(0)
CASES = [(int(SWEEP.integers(1, 257)), int(SWEEP.integers(1, 33)))
         for _ in range(40)] + [(1, 1), (256, 32), (7, 64), (64, 7)]


def _hosts(n):
    return [f"host{i}" for i in range(n)]


@pytest.mark.parametrize("n_shards,n_hosts", CASES)
def test_assign_partitions_evenly_and_matches_reference(n_shards, n_hosts):
    a = elastic.assign(n_shards, _hosts(n_hosts))
    assert sorted(s for v in a.values() for s in v) == list(range(n_shards))
    sizes = [len(v) for v in a.values()]
    assert max(sizes) - min(sizes) <= 1
    assert a == jelastic.assign(n_shards, _hosts(n_hosts))
    assert list(a) == list(jelastic.assign(n_shards, _hosts(n_hosts)))


def test_assign_deterministic_and_order_independent():
    a = elastic.assign(64, _hosts(7))
    assert a == elastic.assign(64, list(reversed(_hosts(7))))
    assert elastic._score(5, "host3") == jelastic._score(5, "host3")
    with pytest.raises(AssertionError, match="no live hosts"):
        elastic.assign(4, [])


def test_failure_moves_few_shards():
    hosts = _hosts(16)
    before = elastic.assign(256, hosts)
    after = elastic.replan_on_failure(256, hosts, dead={"host3"})
    assert after == jelastic.replan_on_failure(256, hosts, dead={"host3"})
    assert sorted(s for v in after.values() for s in v) == list(range(256))
    moved = sum(len(set(before[h]) - set(after.get(h, [])))
                for h in hosts if h != "host3")
    assert moved <= 256 // 16 + 16


@pytest.mark.parametrize("seed", range(8))
def test_replan_and_straggler_match_reference(seed):
    rng = np.random.default_rng(seed)
    n_hosts = int(rng.integers(2, 20))
    n_shards = int(rng.integers(1, 300))
    hosts = _hosts(n_hosts)
    dead = {h for h in hosts if rng.random() < 0.3} - {hosts[0]}
    assert (elastic.replan_on_failure(n_shards, hosts, dead)
            == jelastic.replan_on_failure(n_shards, hosts, dead))
    a = elastic.assign(n_shards, hosts)
    lat = {h: float(rng.uniform(0.5, 3.0)) for h in hosts}
    for threshold in (1.2, 1.5, 3.0):
        got = elastic.straggler_plan(a, lat, threshold)
        assert got == jelastic.straggler_plan(a, lat, threshold)
        assert sorted(s for v in got.values() for s in v) == list(
            range(n_shards))
    assert a == elastic.assign(n_shards, hosts)      # input unchanged


def test_straggler_steals_from_slowest():
    a = elastic.assign(64, _hosts(4))
    lat = {"host0": 1.0, "host1": 1.1, "host2": 1.0, "host3": 5.0}
    b = elastic.straggler_plan(a, lat)
    assert b == jelastic.straggler_plan(a, lat)
    assert len(b["host3"]) < len(a["host3"])
    assert sorted(s for v in b.values() for s in v) == list(range(64))
    lat_ok = {h: 1.0 for h in a}
    assert elastic.straggler_plan(a, lat_ok) == a
    one = elastic.assign(8, _hosts(1))
    assert elastic.straggler_plan(one, {"host0": 9.0}) == one
