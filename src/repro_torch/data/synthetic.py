"""Deterministic CIFAR-like synthetic images (a copy of
``repro/data/pipeline.py::SyntheticImages``; the reference module imports
JAX). Batch ``step`` is a pure function of ``(seed, step, shard)``, so the
port and the reference see the same images for the same seed.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox keyed on (seed, step, shard) — O(1) seek, no sequential state.
    return np.random.Generator(np.random.Philox(
        key=[(seed << 32) ^ step, shard]))


class SyntheticImages:
    """CIFAR-like labeled images: 10 fixed class prototypes + noise."""

    def __init__(self, *, global_batch: int, seed: int = 0,
                 n_shards: int = 1, shard: int = 0, size: int = 32,
                 channels: int = 3, n_classes: int = 10,
                 noise: float = 0.25):
        if global_batch % n_shards:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of n_shards {n_shards}")
        self.local_batch = global_batch // n_shards
        self.seed, self.shard, self.noise = seed, shard, noise
        self.n_classes = n_classes
        g = _rng(seed, 0, 2 ** 30)
        self.protos = g.random((n_classes, size, size, channels),
                               dtype=np.float64).astype(np.float32)

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(images (B, H, W, C) float32 in [0, 1], labels (B,) int32)."""
        g = _rng(self.seed, step, self.shard)
        labels = g.integers(0, self.n_classes,
                            (self.local_batch,)).astype(np.int32)
        x = self.protos[labels]
        x = x + g.standard_normal(x.shape).astype(np.float32) * self.noise
        return np.clip(x, 0.0, 1.0), labels
