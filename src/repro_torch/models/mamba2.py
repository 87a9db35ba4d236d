"""Mamba-2 (SSD) block, the state-space mixer of Zamba2 (arXiv:2411.15242;
counterpart of ``repro/models/mamba2.py``).

Selective state space with a scalar decay per head:

    h_t = exp(Δ_t·A_head)·h_{t−1} + Δ_t·B_t ⊗ x_t          h ∈ R^{P×N}
    y_t = C_t·h_t + D·x_t

Layout: d_inner = 2·d_model, head dim P = 64, N = ``cfg.ssm_state``.
Two forms of the recurrence, chosen as the reference chooses them: the
blocked SSD (``_ssd_chunked``) when S ≥ ``CHUNK`` and S is a multiple of
it, the token scan otherwise (every decode step). The reference's
recurrences are plain ``jax.numpy`` outside any Pallas kernel, so this
port is plain PyTorch. The blocked form computes every chunk's
intra-chunk terms in one batched product and keeps only the state
hand-off in a loop over chunks, the reference's ``lax.scan``.

Dtypes follow the reference: the projections and the causal conv run in
x's dtype, the recurrence in float32; the carried state (h and the conv
tail) is float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.attention import _quant

HEAD_DIM = 64
CONV_K = 4
CHUNK = 64          # blocked-SSD chunk length


def _dims(cfg):
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // HEAD_DIM
    return d_inner, n_heads, cfg.ssm_state


def mamba_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
               device="cpu") -> dict:
    d = cfg.d_model
    d_inner, nh, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    in_proj = layers.dense_init(generator, d, 2 * d_inner + 2 * n + nh,
                                dtype, device)
    conv_w = (layers._normal(generator, (CONV_K, conv_dim), device)
              * 0.1).to(dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "norm": layers.norm_init(d_inner, device=device),
        "out_proj": layers.dense_init(generator, d_inner, d, dtype, device),
    }


class MambaState(NamedTuple):
    h: torch.Tensor          # (B, nh, P, N) ssm state
    conv: torch.Tensor       # (B, CONV_K − 1, conv_dim) conv tail


def init_state(cfg, batch: int, dtype=torch.float32,
               device="cpu") -> MambaState:
    d_inner, nh, n = _dims(cfg)
    return MambaState(
        h=torch.zeros((batch, nh, HEAD_DIM, n), dtype=dtype, device=device),
        conv=torch.zeros((batch, CONV_K - 1, d_inner + 2 * n), dtype=dtype,
                         device=device))


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_inner, nh, n = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time, in xbc's dtype. xbc: (B, S, C);
    tail: (B, K−1, C) → (silu(conv), the new tail in xbc's dtype)."""
    xin = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    s = xbc.shape[1]
    out = xin[:, 0:s, :] * conv_w[0]
    for i in range(1, CONV_K):
        out = out + xin[:, i:i + s, :] * conv_w[i]
    return F.silu(out), xin[:, -(CONV_K - 1):, :]


def _ssd_chunked(xs, bmat, cmat, dt, decay, h0):
    """Mamba-2's blocked SSD: the matmul form inside CHUNK-long blocks.

    xs: (B, S, nh, P) float32; bmat / cmat: (B, S, N); dt / decay: (B, S,
    nh); h0: (B, nh, P, N). The scalar decay per head makes the
    factorization exact: with L = cumsum(log a) inside a chunk,

      y_t = Σ_{j≤t} e^{L_t−L_j}·dt_j·(C_t·B_j)·x_j + e^{L_t}·C_t·h0
      h_C = e^{L_C}·h0 + Σ_j e^{L_C−L_j}·dt_j·B_j⊗x_j

    The (t, j, head) weights are formed first and then taken in one
    product with x, so no (t, j, head, P) tensor is built.
    """
    b, s, nh, p_dim = xs.shape
    n = bmat.shape[-1]
    nc, c = s // CHUNK, CHUNK

    xs_c = xs.reshape(b, nc, c, nh, p_dim)
    b_c = bmat.reshape(b, nc, c, n)
    c_c = cmat.reshape(b, nc, c, n)
    dt_c = dt.reshape(b, nc, c, nh)
    la = torch.log(torch.clamp(decay.reshape(b, nc, c, nh), min=1e-38))
    lcum = torch.cumsum(la, dim=-2)                   # (B,nc,c,nh) L_t incl.
    ltot = lcum[..., -1:, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xs.device))

    # the intra-chunk terms of every chunk at once (no state in them)
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,t,j,nh)
    e_t = torch.exp(lcum)                                    # (B,nc,c,nh)
    g = torch.einsum("bntk,bnjk->bntj", c_c, b_c)           # head-shared
    w = torch.exp(torch.where(mask[:, :, None], ldiff, -torch.inf)) \
        * dt_c[:, :, None, :, :]                            # (B,nc,t,j,nh)
    y_intra = torch.einsum("bntjh,bnjhp->bnthp", g[..., None] * w, xs_c)
    e_end = torch.exp(ltot[:, :, 0])                        # (B,nc,nh)
    kend = torch.exp(ltot - lcum) * dt_c                    # (B,nc,c,nh)
    add = torch.einsum("bnjhp,bnjk->bnhpk", kend[..., None] * xs_c, b_c)

    # the state hand-off, chunk by chunk: h entering each chunk
    h_in = []
    h = h0
    for i in range(nc):
        h_in.append(h)
        h = e_end[:, i, :, None, None] * h + add[:, i]
    y_cross = (torch.einsum("bntk,bnhpk->bnthp", c_c, torch.stack(h_in, 1))
               * e_t[..., None])
    return (y_intra + y_cross).reshape(b, s, nh, p_dim), h


def _ssd_scan(xs, bmat, cmat, dt, decay, h0):
    """The token scan: the recurrence one position at a time. Same
    arguments and result as ``_ssd_chunked``."""
    ys = []
    h = h0
    for t in range(xs.shape[1]):
        dbx = (dt[:, t, :, None, None] * xs[:, t, :, :, None]
               * bmat[:, t, None, None, :])                 # (B,nh,P,N)
        h = decay[:, t, :, None, None] * h + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, cmat[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_forward(p: dict, cfg, x: torch.Tensor, state: MambaState
                  ) -> tuple[torch.Tensor, MambaState]:
    """x: (B, S, D) → (y, new_state). The blocked SSD for S ≥ CHUNK and
    S % CHUNK == 0, the token scan otherwise."""
    b, sl, d = x.shape
    d_inner, nh, n = _dims(cfg)
    quant = _quant(cfg)
    z, xbc, dt = _split_proj(cfg, layers.dense(p["in_proj"], x, quant))
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], state.conv)
    xs = xbc[..., :d_inner].reshape(b, sl, nh, HEAD_DIM)
    bmat = xbc[..., d_inner:d_inner + n]                       # (B,S,N)
    cmat = xbc[..., d_inner + n:]                              # (B,S,N)
    f32 = torch.float32
    # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
    dt = dt.to(f32) + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))             # (B,S,nh)
    a = -torch.exp(p["a_log"])                                 # (nh,)
    decay = torch.exp(dt * a)                                  # (B,S,nh)

    ssd = _ssd_chunked if sl >= CHUNK and sl % CHUNK == 0 else _ssd_scan
    y, h_fin = ssd(xs.to(f32), bmat.to(f32), cmat.to(f32), dt, decay,
                   state.h.to(f32))
    y = y + p["d_skip"][None, None, :, None] * xs.to(f32)      # skip
    y = y.reshape(b, sl, d_inner).to(x.dtype)
    y = layers.apply_norm(p["norm"], y * F.silu(z))
    out = layers.dense(p["out_proj"], y, quant)
    return out, MambaState(h=h_fin, conv=new_tail.to(f32))
