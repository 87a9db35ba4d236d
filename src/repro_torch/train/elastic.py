"""Elastic scaling and straggler mitigation: deterministic assignment of
data shards to hosts (counterpart of ``repro/train/elastic.py``; pure
Python, so the port keeps its own copy).

The data pipeline keys every batch by (seed, step, shard), so any worker
can produce any shard without coordination (``data/pipeline.py``). This
module is the control-plane half: a pure, deterministic assignment of
data shards to live hosts that every host computes on its own from the
same membership view, so there is no assignment server to fail.

* ``assign(shards, hosts)``: balanced, deterministic, minimal-movement
  (rendezvous hashing): when a host dies or joins, only the shards that
  must move, move.
* ``replan_on_failure``: drop dead hosts, rebalance; with a checkpoint
  restore this is the elastic-retrain path.
* ``straggler_plan``: given per-host step latencies, reassigns half of
  the slowest host's shards to the fastest hosts (work stealing). Safe
  because shard batches are position-independent pure functions.
"""
from __future__ import annotations

import hashlib


def _score(shard: int, host: str) -> int:
    h = hashlib.blake2b(f"{shard}|{host}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def assign(n_shards: int, hosts: list[str]) -> dict[str, list[int]]:
    """Rendezvous-hash shards onto hosts, then rebalance to ±1 of even.

    Deterministic in (n_shards, sorted hosts); minimal movement under
    membership change (only shards whose top-scoring host changed move,
    plus the few touched by the ±1 rebalance).
    """
    assert hosts, "no live hosts"
    hosts = sorted(hosts)
    raw = {h: [] for h in hosts}
    for s in range(n_shards):
        raw[max(hosts, key=lambda h: _score(s, h))].append(s)
    # rebalance to exact ±1 quotas (first n_shards % n hosts get the +1)
    lo = n_shards // len(hosts)
    n_hi = n_shards % len(hosts)
    quota = {h: lo + (1 if i < n_hi else 0) for i, h in enumerate(hosts)}
    overflow: list[int] = []
    for h in hosts:
        while len(raw[h]) > quota[h]:
            overflow.append(raw[h].pop())
    for h in hosts:
        while len(raw[h]) < quota[h]:
            raw[h].append(overflow.pop())
    assert not overflow
    return raw


def replan_on_failure(n_shards: int, hosts: list[str],
                      dead: set[str]) -> dict[str, list[int]]:
    live = [h for h in hosts if h not in dead]
    return assign(n_shards, live)


def straggler_plan(assignment: dict[str, list[int]],
                   latencies: dict[str, float],
                   threshold: float = 1.5) -> dict[str, list[int]]:
    """Steal half the slowest host's shards if it lags the median by
    ``threshold``×. Returns a NEW assignment (input unchanged)."""
    out = {h: list(v) for h, v in assignment.items()}
    if len(out) < 2:
        return out
    lat = sorted(latencies.values())
    median = lat[len(lat) // 2]
    slow = max(latencies, key=latencies.get)
    if latencies[slow] < threshold * median or not out[slow]:
        return out
    steal = out[slow][len(out[slow]) // 2:]
    out[slow] = out[slow][:len(out[slow]) // 2]
    fast_hosts = sorted((h for h in out if h != slow),
                        key=lambda h: latencies.get(h, median))
    for i, s in enumerate(steal):
        out[fast_hosts[i % len(fast_hosts)]].append(s)
    return out
