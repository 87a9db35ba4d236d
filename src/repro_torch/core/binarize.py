"""Binarize with straight-through estimation, and the first-layer
quantizers (paper eq. 4, §3.1, eq. 7); counterpart of
``repro/core/binarize.py``.

The paper is inference-only; training follows its Ref. 9 (Courbariaux &
Bengio 2016): latent float "master" weights, ``sign`` on the forward
(eq. 4: ≥ 0 → +1), and a hard-tanh straight-through gradient that passes
only where |x| ≤ 1. ``binarize_ste`` is that estimator as an
``autograd.Function``; where no gradient is recorded (no grad mode, or an
input that needs none: every serving path) it is the bare forward, so the
captured serving steps run exactly the ops they always ran.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import torch


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # hard-tanh STE: the gradient passes only where |x| <= 1
        return torch.where(x.abs() <= 1.0, g, 0.0).to(g.dtype)


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {−1, +1} in x's dtype, +1 at 0 (eq. 4), with the
    straight-through gradient ``where(|x| <= 1, g, 0)``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _BinarizeSTE.apply(x)
    return _sign(x)


def binarize_weights(w: torch.Tensor) -> torch.Tensor:
    """Forward binarization of latent weights (the training forward)."""
    return binarize_ste(w)


def clip_latent(w: torch.Tensor) -> torch.Tensor:
    """Clip latent weights to [−1, 1] after the optimizer step (Ref. 9):
    without it the STE's zero-gradient region freezes weights forever."""
    return torch.clamp(w, -1.0, 1.0)


def quantize_input_6bit(x: torch.Tensor) -> torch.Tensor:
    """Inputs in [0, 1] → integer-valued float32 in [−31, 31] (6-bit)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 62.0 - 31.0)


def quantize_weight_2bit_parts(w: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Latent weights → (q, scale): q in {−1, 0, +1}, scale = max|w|."""
    scale = torch.clamp(w.abs().max(), min=1e-8)
    return torch.round(torch.clamp(w / scale, -1.0, 1.0)), scale


class _Quant2STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        q, scale = quantize_weight_2bit_parts(w)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        return g                  # identity to w; none through the scale


def quantize_weight_2bit(w: torch.Tensor) -> torch.Tensor:
    """Paper eq. (7): 2-bit signed weights {−1, 0, +1}·max|w|, with an
    identity straight-through gradient."""
    return _Quant2STE.apply(w)
