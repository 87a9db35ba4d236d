"""Binary 2-D convolution (counterpart of ``repro/core/bconv.py``): the
differentiable training convs, fold, the two packed dataflows, the fused
conv pair and CONV-1.

* ``binary_conv`` / ``apply_train`` — the STE conv of the training graph
  on ±1 NHWC maps, padded with −1 (bit 0 of the packed encoding), and
  ``fpconv_train`` — CONV-1 (eq. 7) on the STE-quantized 2-bit weights.
  The reference's layout (NHWC maps, (O, FH, FW, I) latents) is kept and
  permuted to NCHW around ``conv2d``.

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
from repro_torch.core.binarize import (binarize_ste, quantize_input_6bit,
                                       quantize_weight_2bit,
                                       quantize_weight_2bit_parts)
from repro_torch.core.normbinarize import (BNParams, NBThreshold,
                                           batchnorm_inference,
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


def _bn_identity(o: int) -> dict:
    return dict(bn_mean=torch.zeros(o), bn_var=torch.ones(o),
                bn_gamma=torch.ones(o), bn_beta=torch.zeros(o))


def init(generator: torch.Generator, in_ch: int, out_ch: int, fh: int = 3,
         fw: int = 3) -> BConvParams:
    """Latent filters U(−1, 1), BN at identity (the reference's
    distributions, not its numbers)."""
    w = torch.rand((out_ch, fh, fw, in_ch), generator=generator) * 2 - 1
    return BConvParams(w=w, **_bn_identity(out_ch))


def fpconv_init(generator: torch.Generator, in_ch: int, out_ch: int,
                fh: int = 3, fw: int = 3) -> FpConvParams:
    """CONV-1 latent filters N(0, 0.1²), BN at identity."""
    w = torch.randn((out_ch, fh, fw, in_ch), generator=generator) * 0.1
    return FpConvParams(w=w, **_bn_identity(out_ch))


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor,
               padding: tuple[int, int]) -> torch.Tensor:
    """NHWC maps × (O, FH, FW, I) filters → NHWC, stride 1. The permuted
    views are NCHW / OIHW tensors in channels-last memory, which cuDNN
    takes as they are."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def binary_conv(p: BConvParams, a_pm1: torch.Tensor, *,
                maxpool: bool = False) -> torch.Tensor:
    """The training graph's binary conv before its BN: ±1 NHWC maps ×
    STE-binarized filters, padded with −1 (the paper's zero padding is in
    the {1, 0} bit encoding, where bit 0 is −1, which keeps the train
    path equal to the packed one), then "VALID"; the 2×2 max-pool is
    taken on this pre-binarize output (paper Fig. 3). The sums are
    integers, exact in float32."""
    fh, fw = p.w.shape[1], p.w.shape[2]
    ap = F.pad(a_pm1, (0, 0, fw // 2, fw // 2, fh // 2, fh // 2),
               value=-1.0)
    y = _conv_nhwc(ap, binarize_ste(p.w), (0, 0))
    return maxpool2x2(y) if maxpool else y


def maxpool2x2(y: torch.Tensor) -> torch.Tensor:
    """2×2, stride-2 max-pool of an NHWC map. Its gradient goes to the
    first maximum of each window in row-major order, as the reference's
    ``reduce_window`` max sends it (integer conv outputs tie often)."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def apply_train(p: BConvParams, a_pm1: torch.Tensor, *,
                binarize_out: bool = True,
                maxpool: bool = False) -> torch.Tensor:
    """Differentiable binary conv (±1 in / ±1 out) with BN from the stored
    statistics and an optional 2×2 max-pool before it; the
    inference-graph oracle of ``apply_packed``."""
    z = batchnorm_inference(binary_conv(p, a_pm1, maxpool=maxpool),
                            BNParams(p.bn_mean, p.bn_var, p.bn_gamma,
                                     p.bn_beta))
    return binarize_ste(z) if binarize_out else z


def fpconv_train(p: FpConvParams, x01: torch.Tensor) -> torch.Tensor:
    """CONV-1 of the training graph before its BN: the 6-bit input
    (rescaled to [−31, 31]) convolved, "SAME", with the STE-quantized
    2-bit weights q·scale (the reference's ``forward_train``); the
    gradient reaches ``p.w`` through the 2-bit STE. The deployment
    ``fpconv_apply`` computes the integer dot and scales afterwards."""
    fh, fw = p.w.shape[1], p.w.shape[2]
    return _conv_nhwc(quantize_input_6bit(x01), quantize_weight_2bit(p.w),
                      (fh // 2, fw // 2))


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
