"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``):
the binary matmuls and convs, with the reference signatures, output dtypes
and padding rules, and flash attention.

Dispatch is by the tensor's device:

* CPU tensor — every ``path`` runs the plain PyTorch version
  (``kernels/ref.py``), as the reference runs Pallas in interpret mode
  off the TPU.
* CUDA tensor — ``"vpu"`` launches K1/K3/K5 (XNOR + popcount on the CUDA
  cores), ``"mxu"`` launches K2/K4/K5 (±1 int8 on the tensor cores), and
  ``"xla"`` raises: the plain version is reached on the card only by
  calling ``kernels/ref.py`` directly. ``binary_weight_matmul`` (K6) and
  ``flash_attention`` (K7) have one kernel each and no ``path``. No
  ``try`` falls back from a kernel.

Padding: pad bits are 0 (−1) in both operands and agree, so the kernels
subtract ``n_pad = Kw·32 − k`` (``L·32 − k`` for the per-position conv
layout); spatial padding is the zero word (all −1); threshold lanes past N
never yield a bit because the kernels mask their ragged edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_conv_fused as kfused
from repro_torch.kernels import xnor_matmul as kmm

PATHS = ("vpu", "mxu", "xla")


def _check_path(path: str, t: torch.Tensor) -> None:
    if path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; use one of {PATHS}")
    if t.is_cuda and path == "xla":
        raise ValueError(
            "path 'xla' is the plain PyTorch version and does not run on "
            "CUDA tensors; use 'vpu' or 'mxu' on the card (or call "
            "repro_torch/kernels/ref.py directly)")


def _thr(thr_c, thr_flip):
    if thr_c is None:
        return None, None
    return thr_c.to(torch.float32), thr_flip.to(torch.bool)


def xnor_matmul(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                thr_c: torch.Tensor | None = None,
                thr_flip: torch.Tensor | None = None,
                path: str = "mxu") -> torch.Tensor:
    """Paper eq. (5): (..., Kw) int32 × (N, Kw) int32 → (..., N).

    Returns int32 agree-counts y_l, or {0,1} int8 bits when per-output
    thresholds are given (fused eq. 8: ``(y_l >= thr_c) XOR thr_flip``).
    ``k`` is the true reduction length (the paper's cnum).
    """
    _check_path(path, a_words)
    lead = a_words.shape[:-1]
    kw = a_words.shape[-1]
    if w_words.shape[-1] != kw:
        raise ValueError(
            f"packed word-count mismatch: activations carry {kw} int32 "
            f"words, weights {w_words.shape[-1]}")
    if bitpack.packed_len(k) != kw:
        raise ValueError(
            f"in_features k={k} needs ceil(k/32)={bitpack.packed_len(k)} "
            f"packed int32 words, got {kw}")
    a2 = a_words.reshape(-1, kw)
    n = w_words.shape[0]
    thr_c, thr_flip = _thr(thr_c, thr_flip)
    if a2.is_cuda:
        fn = kmm.xnor_matmul_vpu if path == "vpu" else kmm.xnor_matmul_mxu
        y = fn(a2.contiguous(), w_words.contiguous(), k=k, thr_c=thr_c,
               thr_flip=thr_flip)
    else:
        y = ref.xnor_matmul_ref(a2, w_words, k)
        if thr_c is not None:
            y = ref.norm_binarize_ref(y, thr_c, thr_flip)
    return y.reshape(*lead, n)


def xnor_conv2d(a_bits: torch.Tensor, w_words: torch.Tensor, *, k: int,
                fh: int, fw: int, stride: int = 1,
                pad: int | tuple[int, int] | None = None,
                thr_c: torch.Tensor | None = None,
                thr_flip: torch.Tensor | None = None,
                path: str = "mxu") -> torch.Tensor:
    """Direct (im2col-free) binary conv: (N, H, W, C) bits × packed filters.

    a_bits:  (N, H, W, C) {0,1} int8 activation bits
    w_words: (O, FH·FW·Cw) int32 per-position packed filters
             (``xnor_conv.pack_conv_weights``)
    k:       true reduction length FH·FW·C
    pad:     scalar or (pad_h, pad_w); default SAME-style (fh//2, fw//2)
    Returns (N, HO, WO, O) int32 agree-counts, or {0,1} int8 bits with
    thresholds. Spatial padding is −1 (bit 0).
    """
    _check_path(path, a_bits)
    if pad is None:
        pad = (fh // 2, fw // 2)
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    n, h, w, c = a_bits.shape
    o, ll = w_words.shape
    kwc = bitpack.packed_len(c)
    if ll != fh * fw * kwc:
        raise ValueError(f"filters carry {ll} words per output; C={c} with "
                         f"{fh}x{fw} taps needs {fh * fw * kwc}")
    thr_c, thr_flip = _thr(thr_c, thr_flip)
    if a_bits.is_cuda:
        aw = bitpack.pack_bits(bitpack.pad_to_pack(a_bits))   # (N,H,W,Cw)
        fn = kconv.xnor_conv2d_vpu if path == "vpu" else kconv.xnor_conv2d_mxu
        return fn(aw, w_words.contiguous(), k=k, fh=fh, fw=fw, stride=stride,
                  pad=(ph, pw), thr_c=thr_c, thr_flip=thr_flip)
    w_bits = bitpack.unpack_bits(w_words.reshape(o, fh, fw, kwc))[..., :c]
    y = ref.xnor_conv2d_ref(a_bits, w_bits, stride=stride, pad=(ph, pw))
    if thr_c is not None:
        y = ref.norm_binarize_ref(y, thr_c, thr_flip)
    return y


def xnor_conv2d_pair(a_bits: torch.Tensor, wa_words: torch.Tensor,
                     wb_words: torch.Tensor, *, ka: int, kb: int,
                     fha: int, fwa: int, fhb: int, fwb: int,
                     pool_b: bool = False,
                     thr_a_c: torch.Tensor, thr_a_flip: torch.Tensor,
                     thr_b_c: torch.Tensor, thr_b_flip: torch.Tensor,
                     path: str = "mxu",
                     tiles: tuple[int, int] | None = None) -> torch.Tensor:
    """Fused pair of same-resolution binary convs: conv A → eq. 8 → conv B
    → eq. 8 (→ 2×2 pool on bits when ``pool_b``), bit-identical to two
    ``xnor_conv2d`` calls and the flip-aware pool. Both convs are stride-1
    SAME with odd filters and −1 (bit 0) padding.

    a_bits:   (N, H, W, C) {0,1} int8, C % 32 == 0 on "vpu"/"mxu"
    wa_words: (OA, FHa·FWa·C/32) int32 per-position packed, OA % 32 == 0
    wb_words: (OB, FHb·FWb·OA/32) int32 per-position packed
    ka/kb:    true reduction lengths (FH·FW·C)
    Returns (N, HO, WO, OB) {0,1} int8, HO = H//2 when ``pool_b`` else H.
    On the card "vpu"/"mxu" launch K5 once with the (th, tw) output tile
    ``tiles`` (None: ``kernels/xnor_conv_fused.py::pick_tiles``); tiles
    never change bits. On a CPU tensor every path runs the plain version
    (``kernels/ref.py::xnor_conv2d_pair_ref``).
    """
    _check_path(path, a_bits)
    if any(f % 2 == 0 for f in (fha, fwa, fhb, fwb)):
        raise ValueError("fused pair supports odd SAME filters only")
    n, h, w, c = a_bits.shape
    oa, la = wa_words.shape
    ob, lb = wb_words.shape
    pf = 2 if pool_b else 1
    if path != "xla" and (c % bitpack.PACK or oa % bitpack.PACK
                          or h % pf or w % pf):
        raise ValueError(f"the fused kernel needs C % 32 == 0 (C={c}), "
                         f"OA % 32 == 0 (OA={oa}) and a map divisible by "
                         f"the pool ({h}x{w}, pool={pool_b})")
    thr_a_c, thr_a_flip = _thr(thr_a_c, thr_a_flip)
    thr_b_c, thr_b_flip = _thr(thr_b_c, thr_b_flip)
    if a_bits.is_cuda:
        if tiles is None:
            tiles = kfused.pick_tiles(
                h // pf, w // pf, pf=pf, fha=fha, fwa=fwa,
                cwa=c // bitpack.PACK, fhb=fhb, fwb=fwb, oa=oa)
        fn = (kfused.xnor_conv2d_pair_vpu if path == "vpu"
              else kfused.xnor_conv2d_pair_mxu)
        return fn(bitpack.pack_bits(a_bits), wa_words.contiguous(),
                  wb_words.contiguous(), ka=ka, kb=kb, fha=fha, fwa=fwa,
                  fhb=fhb, fwb=fwb, pool=pool_b, thr_a_c=thr_a_c,
                  thr_a_flip=thr_a_flip, thr_b_c=thr_b_c,
                  thr_b_flip=thr_b_flip, th=tiles[0], tw=tiles[1])
    kwa, kwb = bitpack.packed_len(c), bitpack.packed_len(oa)
    if la != fha * fwa * kwa or lb != fhb * fwb * kwb:
        raise ValueError(f"filters carry {la} / {lb} words per output; "
                         f"C={c}, OA={oa} need {fha * fwa * kwa} / "
                         f"{fhb * fwb * kwb}")
    wa_bits = bitpack.unpack_bits(wa_words.reshape(oa, fha, fwa, kwa))
    wb_bits = bitpack.unpack_bits(wb_words.reshape(ob, fhb, fwb, kwb))
    return ref.xnor_conv2d_pair_ref(
        a_bits, wa_bits[..., :c], wb_bits[..., :oa], thr_a_c=thr_a_c,
        thr_a_flip=thr_a_flip, thr_b_c=thr_b_c, thr_b_flip=thr_b_flip,
        pool_b=pool_b)


def binary_weight_matmul(a: torch.Tensor, w_words: torch.Tensor, *, k: int,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """Weight-only binary matmul: real (..., K) × packed (N, Kw) → (..., N)
    in a's dtype, the XNOR LM's decode GEMM. Activations are rounded to
    bf16 and multiplied by the ±1 weights with float32 sums; ``scale`` is
    an optional per-output-channel factor (the binary-weight α).

    ``k`` must equal ``a.shape[-1]``, and the weights must carry
    ``ceil(k/32)`` words. A ragged K is padded with zero activations, which
    neutralize the pad weight bits. On the card this launches K6.
    """
    lead = a.shape[:-1]
    kk = a.shape[-1]
    n, kw = w_words.shape
    if k != kk:
        raise ValueError(
            f"k={k} disagrees with the activations' in_features {kk}; pass "
            f"k = a.shape[-1] (the true reduction length)")
    if bitpack.packed_len(kk) != kw:
        raise ValueError(
            f"in_features {kk} needs ceil({kk}/32)={bitpack.packed_len(kk)} "
            f"packed weight words, got {kw}")
    a2 = a.reshape(-1, kk)
    if kk < kw * bitpack.PACK:
        a2 = F.pad(a2, (0, kw * bitpack.PACK - kk))
    s = None if scale is None else scale.reshape(-1).to(torch.float32)
    if a2.is_cuda:
        y = kmm.binary_weight_matmul(
            a2.contiguous(), w_words.contiguous(),
            scale=None if s is None else s.contiguous())
    else:
        y = ref.binary_weight_matmul_ref(a2, w_words, s)
    return y.reshape(*lead, n)


def pack_weights(w_pm1: torch.Tensor) -> torch.Tensor:
    """(N, K) ±1 / real weights → (N, Kw) packed int32 (sign rule, eq. 4)."""
    return bitpack.pack_pm1(w_pm1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention, head-major (B, Hq, S, hd) queries over (B, Hkv,
    S, hd) keys and (B, Hkv, S, dv) values, 1 <= dv <= hd (GQA: query head
    h reads kv head h // (Hq / Hkv)) → (B, Hq, S, dv) in q's dtype, the
    scores scaled by hd ** -0.5; ``causal`` applies the lower-triangular
    mask. float32 or bfloat16, hd <= 256.

    Nothing is padded: keys are masked at the true S (the reference's
    wrapper pads S to its block grid and, with ``causal=False``, lets the
    zero pad keys into the softmax; this does not). On the card this
    launches K7 in the variant ``kernels/flash_attention.py::pick_variant``
    names, which makes the copies its variant needs ("tc" reads strided
    head-major views in place and may return a non-contiguous view). On a
    CPU tensor it runs ``kernels/ref.py::flash_attention_ref``. On every
    device it raises ``RuntimeError`` when autograd records through q, k
    or v (``kfa.check_no_grad``): K7 has no backward.
    """
    kfa.check_inputs(q, k, v)
    kfa.check_no_grad(q, k, v)
    if q.is_cuda:
        return kfa.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)
