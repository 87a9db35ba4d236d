"""Comparator-based normalization — the paper's eq. (8) reformulation.

Counterpart of ``repro/core/normbinarize.py``. Inference batch norm, the
eq. 6 ±1↔{1,0} compensation and the sign binarize fold into one threshold
compare per output channel:

    NormBinarize(y_l, c_l) = (y_l >= c_l) XOR flip_l,

with ``flip_l`` set where γ < 0 (the comparison direction flips). The
derivation is in the reference module's docstring.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BNParams(NamedTuple):
    """Inference-time batch-norm statistics/affine parameters (per channel)."""
    mean: torch.Tensor    # µ
    var: torch.Tensor     # σ²
    gamma: torch.Tensor   # γ
    beta: torch.Tensor    # β
    eps: float = 1e-4


class NBThreshold(NamedTuple):
    """Folded comparator parameters: one threshold (+flip) per channel."""
    c: torch.Tensor       # float32 threshold on the agree-count y_l
    flip: torch.Tensor    # bool: True where γ < 0


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def fold_threshold(bn: BNParams, cnum: int, rounded: bool = True) -> NBThreshold:
    """Fold BN params + eq. 6 compensation into the eq. 8 threshold c_l.

    Folds in host float64 and casts to float32 only at the end: the exact
    c_l can sit within a float32 ulp of an integer, where a float32 fold
    snaps onto the integer and shifts the rounded threshold by one.
    Rounding keeps the integer compare bit-exact against the real BN:
    γ ≥ 0: y_l ≥ c ⇔ y_l ≥ ceil(c); γ < 0: y_l ≤ c ⇔ ¬(y_l ≥ floor(c)+1).
    """
    mean, var = _host64(bn.mean), _host64(bn.var)
    gamma, beta = _host64(bn.gamma), _host64(bn.beta)
    denom = np.where(np.abs(gamma) < 1e-12, 1e-12, gamma)
    c = (cnum + mean - beta * np.sqrt(var + float(bn.eps)) / denom) * 0.5
    if rounded:
        c = np.where(gamma >= 0, np.ceil(c), np.floor(c) + 1.0)
    device = bn.mean.device if isinstance(bn.mean, torch.Tensor) else "cpu"
    return NBThreshold(
        c=torch.tensor(c.astype(np.float32), device=device),
        flip=torch.tensor(gamma < 0, dtype=torch.bool, device=device))


def bn_denom(var: torch.Tensor, eps: float) -> torch.Tensor:
    """``sqrt(var + eps)``, kept as its own op so the caller's division is
    a true division (never a reciprocal multiply)."""
    return torch.sqrt(var + eps)


def bn_affine_exact(normalized: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """``normalized * gamma + beta`` as two separately rounded ops.

    Eager PyTorch runs each op as its own kernel, so nothing contracts the
    pair into a fused multiply-add; do not replace this with ``addcmul``
    or any other fused op — the rounding must match the reference's
    barriered multiply-then-add.
    """
    scaled = normalized * gamma
    return scaled + beta


def norm_binarize(y_l: torch.Tensor, thr: NBThreshold) -> torch.Tensor:
    """Paper eq. (8): the fused comparator. Returns {0,1} bits (int8)."""
    ge = y_l >= thr.c
    return torch.where(thr.flip, ~ge, ge).to(torch.int8)


def batchnorm_inference(y_lo: torch.Tensor, bn: BNParams) -> torch.Tensor:
    """Eq. (2) batch norm on the ±1-domain pre-activation."""
    return bn_affine_exact((y_lo - bn.mean) / bn_denom(bn.var, bn.eps),
                           bn.gamma, bn.beta)


def norm_only(y_l: torch.Tensor, bn: BNParams, cnum: int) -> torch.Tensor:
    """Final layer (paper Fig. 3 step 3): Norm without binarize."""
    return batchnorm_inference(2 * y_l - cnum, bn)
