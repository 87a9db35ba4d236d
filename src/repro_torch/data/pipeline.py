"""Deterministic synthetic data (counterpart of
``repro/data/pipeline.py``; the reference module imports JAX).

Batch ``step`` is a pure function of ``(seed, step, shard)`` (Philox keyed
on them, no sequential state), so a restarted trainer regenerates exactly
the batches it would have seen, and the port and the reference see the
same data for the same seed. Both pipelines draw on the host with numpy.

* ``SyntheticImages``: CIFAR-like labeled images, 10 fixed class
  prototypes + noise (the BCNN's training and evaluation data).
* ``SyntheticLM``: a token stream of short Markov motifs with 5% noise,
  as ``models/transformer.py::Batch`` of CPU int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Batch


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox keyed on (seed, step, shard) — O(1) seek, no sequential state.
    return np.random.Generator(np.random.Philox(
        key=[(seed << 32) ^ step, shard]))


def _split(global_batch: int, n_shards: int) -> int:
    if global_batch % n_shards:
        raise ValueError(f"global_batch {global_batch} is not a "
                         f"multiple of n_shards {n_shards}")
    return global_batch // n_shards


class SyntheticLM:
    """Synthetic tokens with learnable structure: a mixture of short
    motifs from a fixed table (seed only, shared by shards and steps)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_shards: int = 1, shard: int = 0,
                 motif_len: int = 16, n_motifs: int = 64,
                 frontend: tuple[int, int] | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = _split(global_batch, n_shards)
        self.seed, self.shard = seed, shard
        self.frontend = frontend                  # (n_patches, d_model)
        g = _rng(seed, 0, 2 ** 30)
        self.motifs = g.integers(0, vocab_size,
                                 (n_motifs, motif_len)).astype(np.int32)

    def batch(self, step: int) -> Batch:
        g = _rng(self.seed, step, self.shard)
        n, s, ml = self.local_batch, self.seq, self.motifs.shape[1]
        picks = g.integers(0, len(self.motifs), (n, (s + 1) // ml + 2))
        toks = self.motifs[picks].reshape(n, -1)[:, :s + 1].copy()
        # sprinkle noise so the task isn't trivially memorized
        mask = g.random((n, s + 1)) < 0.05
        toks[mask] = g.integers(0, self.vocab, int(mask.sum()))
        fe = None
        if self.frontend is not None:
            p, d = self.frontend
            fe = torch.from_numpy(
                g.standard_normal((n, p, d)).astype(np.float32))
        return Batch(tokens=torch.from_numpy(toks[:, :-1].copy()),
                     targets=torch.from_numpy(toks[:, 1:].copy()),
                     frontend=fe)


class SyntheticImages:
    """CIFAR-like labeled images: 10 fixed class prototypes + noise."""

    def __init__(self, *, global_batch: int, seed: int = 0,
                 n_shards: int = 1, shard: int = 0, size: int = 32,
                 channels: int = 3, n_classes: int = 10,
                 noise: float = 0.25):
        self.local_batch = _split(global_batch, n_shards)
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
