"""Multi-head Latent Attention of DeepSeek-V2 (counterpart of
``repro/models/mla.py``).

K/V are compressed into a rank-``kv_lora_rank`` latent ``c_kv`` plus one
RoPE key per token shared by every head; the cache holds only
(``c_kv``, ``k_rope``), r + dr numbers a token instead of 2·H·hd.

* ``mla_forward`` (training / prefill, no cache) expands ``c_kv`` to full
  K and V, broadcasts ``k_rope`` over the heads, and runs
  ``kernels/ops.py::flash_attention`` on head-major views, q and k at
  ``qk_nope + qk_rope`` and v at its own ``v_head_dim``: K7 on a CUDA
  tensor (at DeepSeek-V2's widths, 192 / 128 in bf16, the tensor-core
  variant "tc"; float32 runs "simt"), its plain version on a CPU tensor.
  The reference zero-pads v to q's width and slices the output back,
  which gives the same values. Its CPU route
  (``attention.blockwise_causal_attention``, which sizes its accumulator
  by q's width, so v is padded there) has the same semantics as the plain
  version. Under autograd (grad mode on and q, k or v requiring grad: a
  training step) it takes that blockwise route on every device, as the
  reference trains off the TPU: K7 has no backward (its wrapper raises
  there). Prefill, serving and any forward under ``torch.no_grad()`` stay
  on K7. It is traced as ``mla.attention`` with device marks
  (``repro_torch/trace.py``).
* ``mla_decode_step`` is the absorbed form: ``W_uk`` folded into the
  query and ``W_uv`` into the output, so one token attends in the latent
  space, with the einsums in float32, as the reference does (no kernel
  there). It updates the cache in place at each slot's own length.

As in the reference, the absorbed decode reads ``wk_b`` and ``wv_b`` raw
while ``mla_forward`` passes them through ``layers.dense``: under the
``binary_weights`` / ``binary`` modes prefill and decode are two different
functions (ROADMAP queue 3). At ``quant="none"`` they are one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import autograd_records
from repro_torch.models import layers
from repro_torch.models.attention import (NEG_INF, _quant,
                                         blockwise_causal_attention)


def mla_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
             device="cpu") -> dict:
    d = cfg.d_model
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = cfg.n_heads

    def dense(d_in, d_out):
        return layers.dense_init(generator, d_in, d_out, dtype, device)
    p = {}
    if rq:
        p["wq_a"] = dense(d, rq)
        p["q_norm"] = layers.norm_init(rq, device=device)
        p["wq_b"] = dense(rq, h * (dn + dr))
    else:
        p["wq"] = dense(d, h * (dn + dr))
    p["wkv_a"] = dense(d, r + dr)                     # c_kv ++ k_rope
    p["kv_norm"] = layers.norm_init(r, device=device)
    p["wk_b"] = dense(r, h * dn)                      # W_uk
    p["wv_b"] = dense(r, h * dv)                      # W_uv
    p["wo"] = dense(h * dv, d)
    return p


def _queries(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)), RoPE applied (none
    with ``cfg.mla_nope``: Kimi Linear's MLA keeps the dr-wide part
    unrotated)."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    quant = _quant(cfg)
    if cfg.q_lora_rank:
        cq = layers.apply_norm(p["q_norm"], layers.dense(p["wq_a"], x, quant))
        q = layers.dense(p["wq_b"], cq, quant)
    else:
        q = layers.dense(p["wq"], x, quant)
    q = q.reshape(b, s, cfg.n_heads, dn + dr)
    if cfg.mla_nope:
        return q[..., :dn], q[..., dn:]
    return q[..., :dn], layers.apply_rope(q[..., dn:], positions,
                                          cfg.rope_theta)


def _latents(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(c_kv (B, S, r) after the kv-norm, k_rope (B, S, dr) after RoPE,
    or unrotated with ``cfg.mla_nope``)."""
    r = cfg.kv_lora_rank
    ckv_rope = layers.dense(p["wkv_a"], x, _quant(cfg))          # (B,S,r+dr)
    c_kv = layers.apply_norm(p["kv_norm"], ckv_rope[..., :r])
    if cfg.mla_nope:
        return c_kv, ckv_rope[..., r:]
    k_rope = layers.apply_rope(ckv_rope[..., r:][:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True) -> torch.Tensor:
    """Training / prefill attention (expanded K/V, no cache). x: (B, S, D).
    K7 through ``ops.flash_attention``, or under autograd the blockwise
    plain attention."""
    with trace.span("mla.attention", device=x.is_cuda):
        b, s, _ = x.shape
        h = cfg.n_heads
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        quant = _quant(cfg)
        q_nope, q_rope = _queries(p, cfg, x, positions)
        c_kv, k_rope = _latents(p, cfg, x, positions)
        k_nope = layers.dense(p["wk_b"], c_kv, quant).reshape(b, s, h, dn)
        v = layers.dense(p["wv_b"], c_kv, quant).reshape(b, s, h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        if autograd_records(q, k, v):
            # one head width for q, k and v in the blockwise scan
            out = blockwise_causal_attention(
                q, k, F.pad(v, (0, dn + dr - dv)), causal=causal)[..., :dv]
        else:
            out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=causal).transpose(1, 2)
        return layers.dense(p["wo"], out.reshape(b, s, h * dv), quant)


class MLACache(NamedTuple):
    """Per-slot latent cache; ``mla_decode_step`` updates it in place."""
    c_kv: torch.Tensor     # (B, S_max, r)
    k_rope: torch.Tensor   # (B, S_max, dr)
    length: torch.Tensor   # (B,) int64 — filled prefix length per slot


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int64, device=device))


def mla_decode_step(p: dict, cfg, x: torch.Tensor, cache: MLACache
                    ) -> tuple[torch.Tensor, MLACache]:
    """Absorbed one-token attention in the latent space. x: (B, 1, D).

    scores = q_nopeᵀ·W_uk·c_kv + q_ropeᵀ·k_rope ; out = (w·c_kv)·W_uvᵀ.
    Each slot writes its latents at its own ``length`` and attends to the
    positions ≤ ``length``; a write past the cache is dropped on the
    device, without a host sync (``attention.gqa_decode_step``'s clamp and
    ``where``). Updates ``cache`` in place and returns it.
    """
    if "w" not in p["wk_b"]:
        raise ValueError("the absorbed decode needs wk_b as a real weight")
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    length = cache.length
    max_len = cache.c_kv.shape[1]
    pos = length[:, None]
    q_nope, q_rope = _queries(p, cfg, x, pos)                 # (B,1,H,·)
    c_new, krope_new = _latents(p, cfg, x, pos)               # (B,1,r),(B,1,dr)
    rows = torch.arange(b, device=x.device)
    slot = torch.clamp(length, max=max_len - 1)
    inside = (length < max_len)[:, None]
    for buf, new in ((cache.c_kv, c_new), (cache.k_rope, krope_new)):
        buf[rows, slot] = torch.where(inside, new[:, 0].to(buf.dtype),
                                      buf[rows, slot])
    f32 = torch.float32
    c_kv = cache.c_kv.to(f32)
    wk = p["wk_b"]["w"].reshape(r, h, dn).to(f32)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), wk)
    sc = (torch.einsum("bqhr,bsr->bqhs", q_lat, c_kv)
          + torch.einsum("bqhd,bsd->bqhs", q_rope.to(f32),
                         cache.k_rope.to(f32)))
    sc = sc * (dn + dr) ** -0.5
    valid = (torch.arange(max_len, device=x.device)[None, None, None, :]
             <= length[:, None, None, None])
    w = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
    o_lat = torch.einsum("bqhs,bsr->bqhr", w, c_kv)
    wv = p["wv_b"]["w"].reshape(r, h, dv).to(f32)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv)
    out = layers.dense(p["wo"], out.reshape(b, 1, h * dv).to(x.dtype),
                       _quant(cfg))
    length.add_(1)
    return out, cache
