"""Binarize and the first-layer quantizers of the deployment path
(paper eq. 4, §3.1, eq. 7).

Forward-only counterparts of ``repro/core/binarize.py``; the straight-
through estimators belong to the training half of the port.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import torch


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {−1, +1} in x's dtype, +1 at 0 (eq. 4): the forward of
    the reference's straight-through binarize."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def quantize_input_6bit(x: torch.Tensor) -> torch.Tensor:
    """Inputs in [0, 1] → integer-valued float32 in [−31, 31] (6-bit)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 62.0 - 31.0)


def quantize_weight_2bit_parts(w: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Latent weights → (q, scale): q in {−1, 0, +1}, scale = max|w|."""
    scale = torch.clamp(w.abs().max(), min=1e-8)
    return torch.round(torch.clamp(w / scale, -1.0, 1.0)), scale


def quantize_weight_2bit(w: torch.Tensor) -> torch.Tensor:
    """Paper eq. (7): 2-bit signed weights {−1, 0, +1}·max|w|."""
    q, scale = quantize_weight_2bit_parts(w)
    return q * scale
