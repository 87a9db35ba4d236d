"""Binary 2-D convolution, deployment half (counterpart of
``repro/core/bconv.py``): fold, the two packed dataflows, the fused conv
pair and CONV-1.

* ``"direct"`` — ``kernels/ops.py::xnor_conv2d``: the channel-packed image
  goes straight through the direct conv kernel (K3/K4 on the card), which
  gathers each FH×FW reception field itself; no im2col buffer.
* ``"im2col"`` — materialize (N, H, W, FH·FW·C) patches, pack them and
  reuse the XNOR matmul (K1/K2 on the card).
* ``"auto"`` — ``direct`` when the channel count is 32-aligned, else
  ``im2col``.
* ``apply_packed_pair`` — two convs in one fused call
  (``kernels/ops.py::xnor_conv2d_pair``, K5 on the card): the bit map
  between them never leaves the kernel. Bit-identical to two
  ``apply_packed`` calls under either strategy.

Layout: NHWC bit maps; im2col packs the flat (FH·FW·C) reduction, the
direct and fused kernels pack per filter position (O, FH·FW·ceil(C/32)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.core.binarize import (quantize_input_6bit,
                                       quantize_weight_2bit_parts)
from repro_torch.core.normbinarize import (BNParams, NBThreshold,
                                           bn_affine_exact, bn_denom,
                                           fold_threshold)
from repro_torch.kernels import ops
from repro_torch.kernels.xnor_conv import pack_conv_weights

DEFAULT_CONV_STRATEGY = "auto"   # "auto" | "direct" | "im2col"
# Cross-layer conv-pair fusion (``apply_packed_pair``, planned by
# core/bcnn.py::plan_layer_groups) is opt-in, as in the reference: the
# forward runs every conv on its own unless a plan turns fusion on
# (``conv_fusion=True``, launch/serve_bcnn.py --conv-fusion, or a tuned
# plan). Fusion is bit-exact, so it changes only the dataflow.
DEFAULT_CONV_FUSION = False


class BConvParams(NamedTuple):
    w: torch.Tensor          # (O, FH, FW, I) latent fp filters
    bn_mean: torch.Tensor    # (O,)
    bn_var: torch.Tensor
    bn_gamma: torch.Tensor
    bn_beta: torch.Tensor


class BConvPacked(NamedTuple):
    w_words: torch.Tensor    # (O, ceil(FH*FW*I/32)) int32 — im2col layout
    thr: NBThreshold
    k: int                   # FH*FW*I = the paper's cnum
    w_words_hw: torch.Tensor | None = None  # (O, FH*FW*ceil(I/32)) — direct
    fh: int = 3
    fw: int = 3


class FpConvParams(NamedTuple):
    """CONV-1 (eq. 7): latent fp filters + BN, kept unpacked."""
    w: torch.Tensor          # (O, FH, FW, I)
    bn_mean: torch.Tensor
    bn_var: torch.Tensor
    bn_gamma: torch.Tensor
    bn_beta: torch.Tensor


def fold(p: BConvParams) -> BConvPacked:
    """Pack the filters in both layouts and fold BN into eq. 8 thresholds."""
    o, fh, fw, i = p.w.shape
    k = fh * fw * i
    bn = BNParams(p.bn_mean, p.bn_var, p.bn_gamma, p.bn_beta)
    return BConvPacked(w_words=bitpack.pack_pm1(p.w.reshape(o, k)),
                       thr=fold_threshold(bn, cnum=k), k=k,
                       w_words_hw=pack_conv_weights(p.w), fh=fh, fw=fw)


def resolve_strategy(strategy: str | None, c: int,
                     fp: BConvPacked | None = None) -> str:
    """Resolve "auto" (and None) to a concrete dataflow for channel count c:
    "direct" when C is 32-aligned (the packed words are the same in both
    layouts), else "im2col"."""
    strategy = strategy or DEFAULT_CONV_STRATEGY
    if strategy == "auto":
        have_hw = fp is None or fp.w_words_hw is not None
        strategy = ("direct" if c % bitpack.PACK == 0 and have_hw
                    else "im2col")
    if strategy not in ("direct", "im2col"):
        raise ValueError(f"unknown conv strategy: {strategy!r}")
    if strategy == "direct" and fp is not None and fp.w_words_hw is None:
        raise ValueError("strategy='direct' needs the per-position weight "
                         "layout; re-fold() the params or use 'im2col'")
    return strategy


def _im2col(x: torch.Tensor, fh: int, fw: int,
            pad: int | tuple[int, int] = 1) -> torch.Tensor:
    """NHWC → (N, H, W, FH*FW*C) patches, stride 1, zero padding (bit 0 =
    −1), ordered (dy, dx, c)."""
    n, h, w, c = x.shape
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(fh) for dx in range(fw)], dim=-1)


def apply_packed(fp: BConvPacked, a_bits: torch.Tensor, *,
                 maxpool: bool = False, path: str = "mxu",
                 strategy: str | None = None) -> torch.Tensor:
    """Packed inference conv with fused eq. 8 on {0,1} int8 NHWC bit maps
    → {0,1} int8 bits.

    The paper pools y_l before NormBinarize; pooling commutes with the
    monotone threshold, so the bits are pooled (2×2, stride 2): max where
    the compare is y ≥ c, min where γ < 0 flips it.
    """
    fh, fw = fp.fh, fp.fw
    strategy = resolve_strategy(strategy, a_bits.shape[-1], fp)
    thr = dict(thr_c=fp.thr.c, thr_flip=fp.thr.flip)
    if strategy == "direct":
        out = ops.xnor_conv2d(a_bits, fp.w_words_hw, k=fp.k, fh=fh, fw=fw,
                              path=path, **thr)
    else:
        patches = _im2col(a_bits, fh, fw, pad=(fh // 2, fw // 2))
        words = bitpack.pack_bits(bitpack.pad_to_pack(patches))
        out = ops.xnor_matmul(words, fp.w_words, k=fp.k, path=path, **thr)
    if not maxpool:
        return out
    n, h, w, c = out.shape
    win = out[:, :h // 2 * 2, :w // 2 * 2, :].reshape(n, h // 2, 2,
                                                      w // 2, 2, c)
    return torch.where(fp.thr.flip[None, None, None, :],
                       win.amin(dim=(2, 4)), win.amax(dim=(2, 4)))


def apply_packed_pair(fa: BConvPacked, fb: BConvPacked,
                      a_bits: torch.Tensor, *, maxpool_b: bool = False,
                      path: str = "mxu",
                      tiles: tuple[int, int] | None = None) -> torch.Tensor:
    """Fused pair of packed binary convs: conv A → NormBinarize → conv B →
    NormBinarize → optional trailing 2×2 bit pool, in one call.

    Bit-exact with ``apply_packed(fa, ...)`` then ``apply_packed(fb, ...,
    maxpool=maxpool_b)`` for either strategy: the fused kernel is its own
    direct-style dataflow. Needs the per-position weight layouts and
    32-aligned channel counts. ``tiles``: the (th, tw) output tile of the
    fused launch from an ``ExecutionPlan`` (None: ``pick_tiles``).
    """
    c = a_bits.shape[-1]
    if fa.w_words_hw is None or fb.w_words_hw is None:
        raise ValueError(
            "fused conv pair needs the per-position weight layout; these "
            "BConvPacked predate it — re-fold() the params")
    oa = fa.w_words_hw.shape[0]
    if c % bitpack.PACK or oa % bitpack.PACK:
        raise ValueError(
            f"fused conv pair needs 32-aligned channels, got C={c}, OA={oa}")
    return ops.xnor_conv2d_pair(
        a_bits, fa.w_words_hw, fb.w_words_hw, ka=fa.k, kb=fb.k,
        fha=fa.fh, fwa=fa.fw, fhb=fb.fh, fwb=fb.fw, pool_b=maxpool_b,
        thr_a_c=fa.thr.c, thr_a_flip=fa.thr.flip,
        thr_b_c=fb.thr.c, thr_b_flip=fb.thr.flip, path=path, tiles=tiles)


def fpconv_apply(p: FpConvParams, x01: torch.Tensor, *,
                 binarize_out: bool = True) -> torch.Tensor:
    """Paper eq. (7): 6-bit input (rescaled to [−31, 31]) × 2-bit weights.

    x01: (N, H, W, C) image in [0, 1]. Returns ±1 float32 (or the BN
    pre-activation z with ``binarize_out=False``), NHWC.

    The 2-bit weights are q·scale with q in {−1, 0, +1}, so the conv is
    computed as the integer dot Σ a0·q — exact in float32 in any summation
    order (|Σ| ≤ 27·31 here), and on the tensor cores even under TF32,
    whose 10-bit mantissa holds both operands — times the scale: one
    rounding, the same on the CPU and the card. The reference convolves
    a0 with q·scale and rounds each partial sum, so its z differs from
    this one by float32 rounding only; a bit can differ only where z is
    within that rounding of 0.
    """
    a0 = quantize_input_6bit(x01)
    q, scale = quantize_weight_2bit_parts(p.w)
    o, fh, fw, _ = q.shape
    n, h, w, _ = a0.shape
    patches = _im2col(a0, fh, fw, pad=(fh // 2, fw // 2))
    y = (patches.reshape(n * h * w, -1) @ q.reshape(o, -1).T) * scale
    y = y.reshape(n, h, w, o)
    z = bn_affine_exact((y - p.bn_mean) / bn_denom(p.bn_var, 1e-4),
                        p.bn_gamma, p.bn_beta)
    if not binarize_out:
        return z
    return torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
