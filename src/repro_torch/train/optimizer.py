"""AdamW over a tree of latent parameters, and the 1-bit gradient
compressor with error feedback (counterpart of
``repro/train/optimizer.py``).

Plain functions over the params tree with the reference's defaults and
its exact order of float32 operations: the global-norm clip with 1e-12
inside the square root, bias corrections 1 − b^step in float32, and
u = (m / bc1) / (sqrt(v / bc2) + eps). ``torch.optim.Adam`` places eps
and the bias corrections differently, so it is not used. For binary
layers the optimizer updates float latent ("master") weights; the
[−1, 1] clip keeps the STE's zero-gradient region from freezing them
(``clip_latent_unit``, or the trainer's clip of the weight leaves).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any
    v: Any


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_latent_unit: bool = False    # binary modes: clip latents to [−1, 1]
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=zeros(), v=zeros())

    def update(self, grads, state: AdamWState, params):
        """One step: returns (new params, new state, global grad norm)."""
        step = state.step + 1
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp(torch.full_like(gnorm, self.grad_clip) / gnorm,
                            max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
        m = tree_map(lambda m_, g: self.b1 * m_ + (1 - self.b1) * g,
                     state.m, grads)
        v = tree_map(lambda v_, g: self.b2 * v_ + (1 - self.b2) * g * g,
                     state.v, grads)
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps)
            pf = p.float()
            newp = pf - self.lr * (u + self.weight_decay * pf)
            if self.clip_latent_unit:
                newp = torch.clamp(newp, -1.0, 1.0)
            return newp.to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamWState(step=step, m=m, v=v), gnorm


# ---------------------------------------------------------------------------
# 1-bit gradient compression with error feedback
# ---------------------------------------------------------------------------

class EFState(NamedTuple):
    residual: Any      # per-leaf float32 error-feedback memory


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_decompress(grads, ef: EFState):
    """sign(g + e)·mean|g + e| per leaf, with error feedback: the wire
    format of a 1-bit data-parallel all-reduce (the paper's ±1 encoding
    applied to gradients, one float scale a leaf). Returns (decompressed
    grads, new error-feedback state)."""
    qs, es = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        t = g.float() + e
        scale = torch.mean(torch.abs(t))
        q = torch.where(t >= 0, scale, -scale)
        qs.append(q)
        es.append(t - q)
    return (tree_unflatten(grads, qs),
            EFState(residual=tree_unflatten(grads, es)))
