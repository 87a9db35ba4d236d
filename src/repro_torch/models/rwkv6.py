"""RWKV-6 "Finch" block (arXiv:2404.05892; counterpart of
``repro/models/rwkv6.py``): an attention-free time mix with a
data-dependent decay, and a squared-ReLU channel mix.

Time-mix recurrence per head (state S ∈ R^{dk×dv}):

    S_t = diag(w_t)·S_{t−1} + k_tᵀ·v_t
    o_t = r_t·(S_{t−1} + diag(u)·k_tᵀ·v_t)

with w_t = exp(−exp(w0 + tanh(x_w·A)·B)). Token shift interpolates each
branch input between x_t and x_{t−1} with learned coefficients μ.

Two forms of the recurrence, chosen as the reference chooses them: the
chunk-parallel matmul form (``_wkv_chunked``) when S ≥ ``CHUNK`` and S is
a multiple of it, the token scan otherwise (every decode step). The
reference's recurrences are plain ``jax.numpy`` outside any Pallas
kernel, so this port is plain PyTorch. The chunked form computes every
chunk's intra-chunk terms in one batched product and keeps only the
state hand-off in a loop over chunks, the reference's ``lax.scan``.

Dtypes follow the reference's promotion: the carried ``tm_prev`` /
``cm_prev`` are float32, so in a bf16 model the shifted mixes, the
time mix's r, k, v, g projections and the whole channel mix run in
float32; the time mix's output goes through ``ln_x`` (a LayerNorm over
the full width d) and ``wo`` in x's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.attention import _quant

HEAD_SIZE = 64
DECAY_LORA = 64
CHUNK = 64          # chunked-wkv block length
_CLAMP = 30.0       # overflow guard on the factorized per-channel decay


def rwkv_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
              device="cpu") -> dict:
    d = cfg.d_model
    h = d // HEAD_SIZE

    def dense(d_in, d_out):
        return layers.dense_init(generator, d_in, d_out, dtype, device)

    def f32(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    tm = {
        "mu": f32((5, d), 0.5),                          # shift mix r,k,v,w,g
        "w0": f32((d,), -6.0),                           # decay bias
        "wa": (layers._normal(generator, (d, DECAY_LORA), device)
               * d ** -0.5).to(dtype),
        "wb": (layers._normal(generator, (DECAY_LORA, d), device)
               * DECAY_LORA ** -0.5).to(dtype),
        "u": f32((h, HEAD_SIZE), 0.0),                   # bonus
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "ln_x": layers.norm_init(d, "layernorm", device),
    }
    cm = {
        "mu": f32((2, d), 0.5),
        "wk": dense(d, cfg.d_ff),
        "wv": dense(cfg.d_ff, d),
        "wr": dense(d, d),
    }
    return {"time_mix": tm, "channel_mix": cm}


class RWKVState(NamedTuple):
    s: torch.Tensor        # (B, H, dk, dv) wkv state
    tm_prev: torch.Tensor  # (B, D) last token for the time-mix shift
    cm_prev: torch.Tensor  # (B, D) last token for the channel-mix shift


def init_state(cfg, batch: int, dtype=torch.float32,
               device="cpu") -> RWKVState:
    d = cfg.d_model
    h = d // HEAD_SIZE
    return RWKVState(
        s=torch.zeros((batch, h, HEAD_SIZE, HEAD_SIZE), dtype=dtype,
                      device=device),
        tm_prev=torch.zeros((batch, d), dtype=dtype, device=device),
        cm_prev=torch.zeros((batch, d), dtype=dtype, device=device))


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None = None
           ) -> torch.Tensor:
    """x_{t−1} along the sequence axis; ``x_prev`` seeds t = 0 (the decode
    carry). The result takes the promoted dtype of the two, as the
    reference's ``jnp.concatenate`` does."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    dt = torch.promote_types(x.dtype, x_prev.dtype)
    return torch.cat([x_prev[:, None, :].to(dt), x[:, :-1].to(dt)], dim=1)


def _branches(tm: dict, cfg, x: torch.Tensor, xp: torch.Tensor):
    """Token-shifted branch inputs → (r, k, v, w, g) per position."""
    b, sl, d = x.shape
    h = d // HEAD_SIZE
    quant = _quant(cfg)
    mu = tm["mu"]
    xx = xp - x
    xr, xk, xv, xw, xg = (x + xx * mu[i] for i in range(5))
    r = layers.dense(tm["wr"], xr, quant).reshape(b, sl, h, HEAD_SIZE)
    k = layers.dense(tm["wk"], xk, quant).reshape(b, sl, h, HEAD_SIZE)
    v = layers.dense(tm["wv"], xv, quant).reshape(b, sl, h, HEAD_SIZE)
    g = F.silu(layers.dense(tm["wg"], xg, quant))
    # the data-dependent decay stays in float32, unbinarized
    dd = torch.tanh(xw.to(torch.float32) @ tm["wa"].to(torch.float32)) \
        @ tm["wb"].to(torch.float32)
    w = torch.exp(-torch.exp(tm["w0"] + dd))                 # (B,S,D) ∈ (0,1)
    return r, k, v, w.reshape(b, sl, h, HEAD_SIZE), g


def _wkv_chunked(r, k, v, w, u, s0):
    """Chunk-parallel wkv (GLA-style): matmul form inside CHUNK-long
    blocks, one state hand-off per block.

    r/k/v: (B, S, H, hs) float32; w: (B, S, H, hs) decay ∈ (0, 1); u: (H,
    hs); s0: (B, H, hs_k, hs_v) float32. Returns (out (B, S, H, hs),
    s_fin). Per chunk, with L = cumsum(log w):

      intra[i, j<i] = Σ_d r_i[d] e^{L[i−1][d] − L[j][d]} k_j[d] · v_j
      diag          = Σ_d r_i[d] u[d] k_i[d] · v_i
      cross         = (r_i ⊙ e^{L[i−1]}) · S_chunk
      S ← diag(e^{L[C]}) S + Σ_j (k_j ⊙ e^{L[C] − L[j]})ᵀ v_j

    The factorized e^{−L[j]} is clamped at e^30, as in the reference.
    """
    b, s, h, hs = r.shape
    nc, c = s // CHUNK, CHUNK

    def resh(t):                                        # (B, nc, H, c, hs)
        return t.reshape(b, nc, c, h, hs).permute(0, 1, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    lw = torch.log(torch.clamp(wc, min=1e-38))
    lcum = torch.cumsum(lw, dim=-2)                     # L[j] inclusive
    lprev = lcum - lw                                   # L[j−1]
    ltot = lcum[..., -1:, :]                            # L[C]

    rr = rc * torch.exp(lprev)                          # r_i e^{L[i−1]}
    kk = kc * torch.exp(torch.clamp(-lcum, max=_CLAMP))  # k_j e^{−L[j]}
    kend = kc * torch.exp(ltot - lcum)                  # k_j e^{L[C]−L[j]}
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)

    # the intra-chunk terms of every chunk at once (no state in them)
    att = torch.where(mask, torch.einsum("bnhid,bnhjd->bnhij", rr, kk), 0.0)
    diag = torch.sum(rc * u[None, None, :, None, :] * kc, dim=-1)
    intra = torch.einsum("bnhij,bnhjv->bnhiv", att, vc) + diag[..., None] * vc
    add = torch.einsum("bnhjd,bnhjv->bnhdv", kend, vc)
    keep = torch.exp(ltot).transpose(-1, -2)            # (B, nc, H, hs, 1)

    # the state hand-off, chunk by chunk: S entering each chunk
    s_in = []
    s_carry = s0
    for i in range(nc):
        s_in.append(s_carry)
        s_carry = keep[:, i] * s_carry + add[:, i]
    out = intra + torch.einsum("bnhid,bnhdv->bnhiv", rr,
                               torch.stack(s_in, dim=1))
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, hs), s_carry


def _wkv_scan(r, k, v, w, u, s0):
    """The token scan: the recurrence one position at a time. Same
    arguments and result as ``_wkv_chunked``."""
    outs = []
    s = s0
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B,H,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def time_mix_forward(tm: dict, cfg, x: torch.Tensor, state: RWKVState
                     ) -> tuple[torch.Tensor, RWKVState]:
    """x: (B, S, D) → (out, new_state). S ≥ CHUNK and S % CHUNK == 0 →
    the chunk-parallel form, else the token scan."""
    b, sl, d = x.shape
    xp = _shift(x, state.tm_prev)
    r, k, v, w, g = _branches(tm, cfg, x, xp)
    wkv = (_wkv_chunked if sl >= CHUNK and sl % CHUNK == 0 else _wkv_scan)
    f32 = torch.float32
    out, s_fin = wkv(r.to(f32), k.to(f32), v.to(f32), w.to(f32), tm["u"],
                     state.s.to(f32))
    out = layers.apply_norm(tm["ln_x"], out.reshape(b, sl, d).to(x.dtype),
                            "layernorm")
    out = layers.dense(tm["wo"], out * g.to(out.dtype), _quant(cfg))
    return out, RWKVState(s=s_fin, tm_prev=x[:, -1, :].to(f32),
                          cm_prev=state.cm_prev)


def channel_mix_forward(cm: dict, cfg, x: torch.Tensor, state: RWKVState
                        ) -> tuple[torch.Tensor, RWKVState]:
    quant = _quant(cfg)
    xp = _shift(x, state.cm_prev)
    xx = xp - x
    xk = x + xx * cm["mu"][0]
    xr = x + xx * cm["mu"][1]
    k = torch.square(F.relu(layers.dense(cm["wk"], xk, quant)))
    kv = layers.dense(cm["wv"], k, quant)
    out = torch.sigmoid(layers.dense(cm["wr"], xr, quant)) * kv
    return out, state._replace(cm_prev=x[:, -1, :].to(torch.float32))
