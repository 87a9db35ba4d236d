"""Binary linear layer, deployment half (counterpart of
``repro/core/blinear.py``): packed weights + folded eq. 8 threshold,
dispatched to ``kernels/ops.py::xnor_matmul`` (K1/K2 on the card).

Weight layout: (out_features, in_features), packed along the reduction
axis (the last axis).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.normbinarize import BNParams, NBThreshold, fold_threshold
from repro_torch.kernels import ops


class BLinearParams(NamedTuple):
    """Latent parameters of a binary linear layer + its norm."""
    w: torch.Tensor          # (out, in) latent fp weights
    bn_mean: torch.Tensor    # (out,)
    bn_var: torch.Tensor
    bn_gamma: torch.Tensor
    bn_beta: torch.Tensor


class BLinearPacked(NamedTuple):
    """Deployment artifact: packed weights + folded eq. 8 threshold."""
    w_words: torch.Tensor    # (out, ceil(in/32)) int32
    thr: NBThreshold
    k: int                   # true reduction length


def fold(p: BLinearParams) -> BLinearPacked:
    """Pack the weights and fold BN into the eq. 8 threshold."""
    k = p.w.shape[1]
    bn = BNParams(p.bn_mean, p.bn_var, p.bn_gamma, p.bn_beta)
    return BLinearPacked(w_words=bitpack.pack_pm1(p.w),
                         thr=fold_threshold(bn, cnum=k), k=k)


def apply_packed(fp: BLinearPacked, a_bits_words: torch.Tensor, *,
                 path: str = "mxu") -> torch.Tensor:
    """(..., in/32) int32 packed activations → {0,1} int8 bits (the XNOR
    matmul with the fused eq. 8 comparator)."""
    return ops.xnor_matmul(a_bits_words, fp.w_words, k=fp.k,
                           thr_c=fp.thr.c, thr_flip=fp.thr.flip, path=path)
