"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/ref.py``).

They are what every wrapper in ``kernels/ops.py`` runs on a CPU tensor,
and what ``chip_smoke.py`` holds the CUDA kernels against on the card.

Each computes the ±1 dot product as a float32 matrix product of the
unpacked operands. That is exact while every partial sum stays below
2**24 in magnitude; the largest reduction on the Table 2 path is
k = 8192 (FC-1). ``xnor_conv2d_pair_ref`` is the fused pair (K5) as two
of those convs. ``binary_weight_matmul_ref`` (K6) multiplies real
activations, rounded to bf16, by the unpacked ±1 weights in float32: the
products are exact, so only the order of the float32 sums can differ
from the kernel's. On a CUDA tensor the product goes to cuBLAS, so a caller
there keeps float32 accumulation: ``chip_smoke.py`` turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the PyTorch default)
before it calls these. ``flash_attention_ref`` (K7) is dense softmax
attention with float32 scores and softmax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack


def xnor_matmul_ref(a_words: torch.Tensor, w_words: torch.Tensor,
                    k: int) -> torch.Tensor:
    """(M, Kw) × (N, Kw) packed int32 → (M, N) int32 agree-counts (eq. 5).

    Over the Kw·32 padded positions the ±1 dot gives agree = (Kw·32 +
    dot)/2; the pad bits (0 in both operands) agree, so n_pad = Kw·32 − k
    is subtracted.
    """
    kp = a_words.shape[-1] * bitpack.PACK
    a = bitpack.decode_pm1(bitpack.unpack_bits(a_words))
    w = bitpack.decode_pm1(bitpack.unpack_bits(w_words))
    dot = a @ w.T
    return ((dot + kp) / 2).to(torch.int32) - (kp - k)


def xnor_matmul_pm1_ref(a_pm1: torch.Tensor,
                        w_pm1: torch.Tensor) -> torch.Tensor:
    """``xnor_matmul_ref``'s contract in the ±1 domain: (M, K) × (N, K)
    → y_l = (K + a·wᵀ) / 2 as int32 (eqs. 5/6 inverse). The dot runs in
    float64, exact for ±1 operands."""
    k = a_pm1.shape[-1]
    dot = a_pm1.to(torch.float64) @ w_pm1.to(torch.float64).T
    return torch.div(k + dot, 2, rounding_mode="floor").to(torch.int32)


def binary_weight_matmul_ref(a: torch.Tensor, w_words: torch.Tensor,
                             scale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Real (M, Kw·32) activations × packed (N, Kw) ±1 weights → (M, N)
    in a's dtype: a rounded to bf16, ±1 products summed in float32, times
    the per-column ``scale`` when given. Activations past the true K are
    zero, so the pad weight bits add nothing."""
    a32 = a.to(torch.bfloat16).to(torch.float32)
    y = a32 @ bitpack.decode_pm1(bitpack.unpack_bits(w_words)).T
    if scale is not None:
        y = y * scale
    return y.to(a.dtype)


def norm_binarize_ref(y_l: torch.Tensor, c: torch.Tensor,
                      flip: torch.Tensor) -> torch.Tensor:
    """The fused NormBinarize epilogue (eq. 8) over the last axis."""
    ge = y_l >= c
    return torch.where(flip.to(torch.bool), ~ge, ge).to(torch.int8)


def xnor_conv2d_ref(a_bits: torch.Tensor, w_bits: torch.Tensor, *,
                    stride: int = 1,
                    pad: int | tuple[int, int] = 1) -> torch.Tensor:
    """Direct binary conv (eq. 3/5) on bits.

    a_bits: (N, H, W, C) {0,1}; w_bits: (O, FH, FW, C) {0,1}.
    Returns (N, HO, WO, O) int32 agree-counts. Spatial padding encodes −1
    (bit 0), as in the packed kernels.
    """
    n, h, w, c = a_bits.shape
    o, fh, fw, _ = w_bits.shape
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    ap = F.pad(bitpack.decode_pm1(a_bits), (0, 0, pw, pw, ph, ph),
               value=-1.0)
    ho = (h + 2 * ph - fh) // stride + 1
    wo = (w + 2 * pw - fw) // stride + 1
    cols = [ap[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride, :]
            for dy in range(fh) for dx in range(fw)]
    k = fh * fw * c
    patches = torch.cat(cols, dim=-1).reshape(-1, k)   # (dy, dx, c) order
    dot = patches @ bitpack.decode_pm1(w_bits).reshape(o, k).T
    return ((dot + k) / 2).to(torch.int32).reshape(n, ho, wo, o)


def xnor_conv2d_pair_ref(a_bits: torch.Tensor, wa_bits: torch.Tensor,
                         wb_bits: torch.Tensor, *, thr_a_c: torch.Tensor,
                         thr_a_flip: torch.Tensor, thr_b_c: torch.Tensor,
                         thr_b_flip: torch.Tensor,
                         pool_b: bool = False) -> torch.Tensor:
    """The fused conv pair as two calls: conv A → eq. 8 → conv B → eq. 8
    → optional 2×2 pool on bits (max where B's flip is 0, min where it is
    1). Both convs are stride 1, SAME, with −1 (bit 0) padding.

    a_bits (N, H, W, C), wa_bits (OA, FHa, FWa, C), wb_bits (OB, FHb,
    FWb, OA), all {0,1}. Returns (N, HO, WO, OB) {0,1} int8.
    """
    fha, fwa = wa_bits.shape[1:3]
    fhb, fwb = wb_bits.shape[1:3]
    y = xnor_conv2d_ref(a_bits, wa_bits, pad=(fha // 2, fwa // 2))
    bits = norm_binarize_ref(y, thr_a_c, thr_a_flip)
    y = xnor_conv2d_ref(bits, wb_bits, pad=(fhb // 2, fwb // 2))
    out = norm_binarize_ref(y, thr_b_c, thr_b_flip)
    if not pool_b:
        return out
    n, h, w, o = out.shape
    win = out[:, :h // 2 * 2, :w // 2 * 2, :].reshape(n, h // 2, 2,
                                                      w // 2, 2, o)
    return torch.where(thr_b_flip.to(torch.bool)[None, None, None, :],
                       win.amin(dim=(2, 4)), win.amax(dim=(2, 4)))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Dense softmax attention, the plain version of K7 (a copy of the
    reference's oracle).

    q: (B, Hq, S, hd); k: (B, Hkv, S, hd); v: (B, Hkv, S, dv) with
    Hq % Hkv == 0 and dv <= hd (``flash_attention.check_inputs``). Scores
    and softmax in float32, scaled by hd ** -0.5; ``p / l`` cast to v's
    dtype for the product with V; ``causal`` applies the lower-triangular
    mask. Every key is one of the true S (nothing is padded). Returns
    (B, Hq, S, dv) in q's dtype.
    """
    s, hd = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kr = torch.repeat_interleave(k, g, dim=1)
    vr = torch.repeat_interleave(v, g, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                      kr.to(torch.float32)) * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        sc = torch.where(mask[None, None], sc, -1e30)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(vr.dtype), vr)
    return out.to(q.dtype)
