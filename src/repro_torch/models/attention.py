"""Attention of the LM zoo (counterpart of the GQA half of
``repro/models/attention.py``): GQA/MHA with RoPE and qk-norm, sliding
windows, a KV cache and the one-token decode step.

* ``gqa_forward`` (training / prefill, no cache) runs the whole sequence
  through ``kernels/ops.py::flash_attention``: K7 on a CUDA tensor, where
  the reference takes its TPU branch to the Pallas kernel, and the plain
  version on a CPU tensor. It hands K7 head-major ``(B, H, S, hd)``
  views of q, k and v (``transpose(1, 2)``, no copy: the tensor-core
  variant reads them in place, the CUDA-core one gets copies from
  ``ops``), and K7 tc's output view transposes back to a contiguous
  ``(B, S, H, hd)``; GQA is native, K/V are not repeated.
* ``gqa_decode_step`` attends one token per slot to the cache with a dense
  einsum, as the reference does (no kernel there). It updates the cache in
  place at each slot's own length.

* With ``cfg.window`` set (sliding-window attention), ``gqa_forward``
  takes ``blockwise_causal_attention`` on every device, never K7, as the
  reference does on every backend; ``gqa_decode_step`` masks the keys
  that fell out of the window. No config of the zoo sets a window.
* Under autograd (grad mode on and q, k or v requiring grad: a training
  step), ``gqa_forward`` takes ``blockwise_causal_attention`` on every
  device too, with K/V repeated to the query heads and the reference's
  ``block`` and ``causal``: the reference trains through it off the TPU,
  and K7 has no backward (its wrapper raises there). Prefill, serving and
  any forward under ``torch.no_grad()`` stay on K7. Whisper's encoder
  inherits the rule.

* ``cross_attn_forward`` (the audio family's decoder) attends every
  query to the encoder's K/V in plain PyTorch, as the reference does: K7
  takes equal query and key lengths, and here S differs from S_enc.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import autograd_records
from repro_torch.models import layers

NEG_INF = -1e30


def attn_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
              device="cpu") -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": layers.dense_init(generator, d, cfg.n_heads * hd, dtype, device),
        "wk": layers.dense_init(generator, d, cfg.n_kv_heads * hd, dtype,
                                device),
        "wv": layers.dense_init(generator, d, cfg.n_kv_heads * hd, dtype,
                                device),
        "wo": layers.dense_init(generator, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.norm_init(hd, device=device)
        p["k_norm"] = layers.norm_init(hd, device=device)
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV·groups, hd) for GQA head sharing."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, block: int = 1024,
                               q_block: int | None = None,
                               window: int | None = None,
                               causal: bool = True) -> torch.Tensor:
    """Flash-style attention in plain PyTorch, the reference's: a loop over
    KV blocks (optionally inside one over Q blocks) with an online
    softmax. q, k, v: (B, S, H, hd), K/V already repeated to H heads →
    (B, S, H, hd).

    Scores and the running max / sum / accumulator are float32; the
    exponentials are rounded to v's dtype before their product with V and
    their sum, as in the reference. Keys past S (padding to whole blocks),
    in the future (``causal``) or ``window`` or more positions back are
    masked.
    """
    b, s, h, hd = q.shape
    q_block = s if q_block is None else q_block
    scale = hd ** -0.5
    nb = -(-s // block)
    pad = nb * block - s
    nqb = -(-s // q_block)
    qpad = nqb * q_block - s
    f32 = torch.float32
    # head-major (B, H, S, hd), padded to whole blocks
    kh = F.pad(k, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    vh = F.pad(v, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    qh = F.pad(q, (0, 0, 0, 0, 0, qpad)).transpose(1, 2)
    outs = []
    for qi in range(nqb):
        qblk = qh[:, :, qi * q_block:(qi + 1) * q_block]
        q_pos = qi * q_block + torch.arange(q_block, device=q.device)
        m = torch.full((b, h, q_block), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, q_block, hd), dtype=f32, device=q.device)
        for blk in range(nb):
            kblk = kh[:, :, blk * block:(blk + 1) * block]
            vblk = vh[:, :, blk * block:(blk + 1) * block]
            kv_pos = blk * block + torch.arange(block, device=q.device)
            sc = torch.einsum("bhqd,bhkd->bhqk", qblk.to(f32),
                              kblk.to(f32)) * scale
            mask = (kv_pos < s)[None, :]                 # drop pad keys
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None]).to(vblk.dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p.to(f32).sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(f32), vblk.to(f32))
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)[:, :s]


def _quant(cfg) -> str:
    # attention activations stay real even in "binary" mode (the softmax
    # is meaningless over ±1 logits), as in the reference
    return cfg.quant if cfg.quant != "binary" else "binary_weights"


def _qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Projections, qk-norm and RoPE: (B, S, H|KV, hd) each."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    quant = _quant(cfg)
    q = layers.dense(p["wq"], x, quant).reshape(b, s, h, hd)
    k = layers.dense(p["wk"], x, quant).reshape(b, s, kvh, hd)
    v = layers.dense(p["wv"], x, quant).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = layers.apply_norm(p["q_norm"], q)
        k = layers.apply_norm(p["k_norm"], k)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True) -> torch.Tensor:
    """Training / prefill attention (no cache). x: (B, S, D). K7 through
    ``ops.flash_attention``, or, with ``cfg.window`` or under autograd
    (``autograd_records``), the blockwise plain attention."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if cfg.window is not None or autograd_records(q, k, v):
        g = cfg.n_heads // cfg.n_kv_heads
        out = blockwise_causal_attention(q, _repeat_kv(k, g),
                                         _repeat_kv(v, g), window=cfg.window,
                                         causal=causal)
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  causal=causal).transpose(1, 2)
    return layers.dense(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.head_dim),
                        _quant(cfg))


class KVCache(NamedTuple):
    """Per-slot KV cache; ``gqa_decode_step`` updates it in place."""
    k: torch.Tensor        # (B, S_max, KV, hd)
    v: torch.Tensor        # (B, S_max, KV, hd)
    length: torch.Tensor   # (B,) int64 — filled prefix length per slot


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int64,
                                      device=device))


def gqa_decode_step(p: dict, cfg, x: torch.Tensor, cache: KVCache
                    ) -> tuple[torch.Tensor, KVCache]:
    """One-token attention against the cache. x: (B, 1, D).

    Each slot writes its K/V at its own ``length`` and attends to the
    positions ≤ ``length`` (and, with ``cfg.window``, > ``length`` −
    window), so slots at different depths share one step.
    A write at a length past the cache is dropped (the reference's
    ``mode="drop"`` scatter): the old row is written back at a clamped
    index, on the device and without a host sync. Updates ``cache`` (K, V
    and length) in place and returns it.
    """
    b = x.shape[0]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    length = cache.length
    max_len = cache.k.shape[1]
    q, k, v = _qkv(p, cfg, x, length[:, None])
    rows = torch.arange(b, device=x.device)
    slot = torch.clamp(length, max=max_len - 1)
    inside = (length < max_len)[:, None, None]
    cache.k[rows, slot] = torch.where(inside, k[:, 0].to(cache.k.dtype),
                                      cache.k[rows, slot])
    cache.v[rows, slot] = torch.where(inside, v[:, 0].to(cache.v.dtype),
                                      cache.v[rows, slot])
    # grouped-query attention on the cache at kv-head granularity (no
    # repeated K/V), scores and softmax in float32
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    sc = torch.einsum("bqkgd,bskd->bqkgs", qg.to(torch.float32),
                      cache.k.to(torch.float32)) * hd ** -0.5
    kv_pos = torch.arange(max_len, device=x.device)[None, None, None, None, :]
    idx = length[:, None, None, None, None]                   # per slot
    valid = kv_pos <= idx
    if cfg.window is not None:
        valid = valid & (kv_pos > idx - cfg.window)
    w = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd",
                       w.to(cache.v.dtype).to(torch.float32),
                       cache.v.to(torch.float32))
    out = layers.dense(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype),
                       _quant(cfg))
    length.add_(1)
    return out, cache


def cross_attn_forward(p: dict, cfg, x: torch.Tensor, enc_k: torch.Tensor,
                       enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of the whisper decoder: full, non-causal, on the
    encoder's K/V. x: (B, S, D); enc_k / enc_v: (B, S_enc, H, hd).

    As in the reference: float32 scores and softmax, the weights rounded
    to ``enc_v``'s dtype before their product with V, which sums in
    float32, and the result cast to x's dtype before ``wo``.
    """
    b, s, _ = x.shape
    hd, h = cfg.head_dim, cfg.n_heads
    f32 = torch.float32
    q = layers.dense(p["wq"], x, _quant(cfg)).reshape(b, s, h, hd)
    sc = torch.einsum("bqhd,bkhd->bqhk", q.to(f32),
                      enc_k.to(f32)) * hd ** -0.5
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", w.to(enc_v.dtype).to(f32),
                       enc_v.to(f32))
    return layers.dense(p["wo"], out.reshape(b, s, h * hd).to(x.dtype),
                        _quant(cfg))
