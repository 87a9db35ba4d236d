"""Attention of the dense LM zoo (counterpart of the GQA half of
``repro/models/attention.py``): GQA/MHA with RoPE and qk-norm, a KV cache
and the one-token decode step.

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

``cfg.window`` (sliding-window attention, the reference's
``blockwise_causal_attention`` path of the hybrid family) and
``cross_attn_forward`` (the audio family) come with those families.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
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


def _check_window(cfg) -> None:
    if cfg.window is not None:
        raise NotImplementedError(
            "sliding-window attention (cfg.window) comes with the hybrid "
            "family; see ROADMAP queue 1")


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
    """Training / prefill attention (no cache). x: (B, S, D)."""
    _check_window(cfg)
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal).transpose(1, 2)
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
    positions ≤ ``length``, so slots at different depths share one step.
    A write at a length past the cache is dropped (the reference's
    ``mode="drop"`` scatter): the old row is written back at a clamped
    index, on the device and without a host sync. Updates ``cache`` (K, V
    and length) in place and returns it.
    """
    _check_window(cfg)
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
    valid = (torch.arange(max_len, device=x.device)[None, None, None, None, :]
             <= length[:, None, None, None, None])
    w = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd",
                       w.to(cache.v.dtype).to(torch.float32),
                       cache.v.to(torch.float32))
    out = layers.dense(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype),
                       _quant(cfg))
    length.add_(1)
    return out, cache
