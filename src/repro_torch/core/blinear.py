"""Binary linear layer, the paper's XnorDotProduct (eq. 5); counterpart
of ``repro/core/blinear.py``. Two modes:

* ``apply_train``: differentiable — latent weights and ±1 activations
  binarized with the STE, a ±1 float32 matmul, BN with stored statistics;
* ``apply_packed``: packed weights + folded eq. 8 threshold, dispatched
  to ``kernels/ops.py::xnor_matmul`` (K1/K2 on the card).

Weight layout: (out_features, in_features), packed along the reduction
axis (the last axis).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitpack
from repro_torch.core.binarize import binarize_ste
from repro_torch.core.normbinarize import (BNParams, NBThreshold,
                                           batchnorm_inference,
                                           fold_threshold)
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


def init(generator: torch.Generator, in_features: int,
         out_features: int) -> BLinearParams:
    """Latent weights U(−1, 1), BN at identity (the reference's
    distributions; ``jax.random`` and ``torch.Generator`` are different
    streams, so not its numbers)."""
    o = out_features
    return BLinearParams(
        w=torch.rand((o, in_features), generator=generator) * 2 - 1,
        bn_mean=torch.zeros(o), bn_var=torch.ones(o),
        bn_gamma=torch.ones(o), bn_beta=torch.zeros(o))


def apply_train(p: BLinearParams, a_pm1: torch.Tensor, *,
                binarize_out: bool = True) -> torch.Tensor:
    """Differentiable forward: (..., in) ±1 activations × binarized
    weights → BN with the stored statistics → ±1 (or the BN output z with
    ``binarize_out=False``, the final layer's Norm). The ±1 product is
    integer-valued and exact in float32, so it equals the packed path's
    agree-counts, and the BN is the packed path's own
    (``normbinarize.batchnorm_inference``)."""
    y = a_pm1 @ binarize_ste(p.w).T
    z = batchnorm_inference(y, BNParams(p.bn_mean, p.bn_var, p.bn_gamma,
                                        p.bn_beta))
    return binarize_ste(z) if binarize_out else z


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
