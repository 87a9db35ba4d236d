"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi Linear
(arXiv:2510.26692; huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct).

A gated delta rule with a decay per head and key channel. With x after
the layer's pre-norm, H = ``cfg.kda_heads`` heads of d_k = d_v =
``cfg.kda_head_dim``:

    q̃, k̃, ṽ = x W_q, x W_k, x W_v            (one fused product, "wqkv")
    q = L2norm(SiLU(conv(q̃))), k = L2norm(SiLU(conv(k̃))),
    v = SiLU(conv(ṽ))                        (conv: causal, depthwise,
                                              width 4, no bias)
    g = −exp(A_log[h]) · softplus(x W_f↓ W_f↑ + dt_bias)     α = exp(g)
    β = sigmoid(x W_b)                                       (per head)
    S_t = (I − β_t k_t k_tᵀ) Diag(α_t) S_{t−1} + β_t k_t v_tᵀ
    o_t = S_tᵀ q_t / √d_k
    y = W_o [RMSNorm_head(o) ⊙ sigmoid(x W_g↓ W_g↑)]

L2norm and the RMSNorm act per head (the RMSNorm's scale is shared by
the heads). S is zero at a prompt's start.

Two forms of the rule. ``_scan``, the recurrence one token at a time,
takes a decode step. ``_chunked`` takes every longer input: CHUNK
positions at a time, in float32, the chunk's algebra for all chunks at
once and only the state's pass from chunk to chunk in a Python loop, one
``baddbmm`` a chunk. Inside a chunk, with G the cumulative log decay
(inclusive) and u_t = β_t (v_t − k_tᵀ Diag(α_t) S_{t−1}) (the WY form of
the delta rule):

    A[t, j] = β_t Σ_d k_t[d] k_j[d] e^{G_t[d] − G_j[d]}        (j < t)
    P[t, j] = Σ_d q_t[d] k_j[d] e^{G_t[d] − G_j[d]} / √d_k     (j ≤ t)
    (I + A) [W | U0] = [β ⊙ e^{G} ⊙ k | β ⊙ v]                 (U = U0 − W S)
    O      = P U0 + (e^{G} ⊙ q/√d_k − P W) S
    S_next = (Diag(e^{G_C}) − K̂ᵀ W) S + K̂ᵀ U0,   K̂_j = e^{G_C − G_j} ⊙ k_j

Every factor e^{...} there is at most 1 save the pairwise ones in A and
P. Those are formed without overflow and without a (C, C, d_k) tensor
(``_decayed_products``): blocks of 16 and then 4 positions, the products
between a block and the blocks before it factored about the last
position before the block (both factors ≤ 1), and within a block of 4
the sub-diagonals one at a time. (I + A)^{-1} is built by blocks of
doubling size (``_unit_lower_inverse``), then applied by two products.
The inputs are laid out chunk-major, heads before positions
(``to_chunks``), and cast to float32 in the same copy. A prompt whose
length is not a multiple of CHUNK is padded with positions that leave
the state unchanged (q = k = v = 0, α = 1) and their outputs dropped.

Traced (``repro_torch/trace.py``) in spans with device marks:
``kda.proj`` (projections, conv, gates), ``kda.scan`` (the rule) and
``kda.out`` (norm, gate, ``W_o``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models import layers, mamba2
from repro_torch.models.attention import _quant

CONV_K = mamba2.CONV_K          # the short conv's width, 4 as in the release
CHUNK = 64
BLOCKS = (16, 4)                # the levels of ``_decayed_products``
L2_EPS = 1e-6


def _width(cfg) -> int:
    return cfg.kda_heads * cfg.kda_head_dim


def kda_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
             device="cpu") -> dict:
    """Weights in ``dtype``; the decay's A_log and dt_bias and the output
    norm's scale in float32. A_log = log U(1, 16) per head, and dt_bias the
    inverse softplus of a rate log-uniform in [1e-3, 0.1] per channel (the
    release's init)."""
    # the gates' low-rank projections are a head wide, as in the release
    d, w, r = cfg.d_model, _width(cfg), cfg.kda_head_dim

    def dense(d_in, d_out):
        return layers.dense_init(generator, d_in, d_out, dtype, device)

    def uniform(shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)

    dt = torch.exp(uniform((w,)) * (torch.log(torch.tensor(0.1))
                                    - torch.log(torch.tensor(1e-3)))
                   + torch.log(torch.tensor(1e-3)))
    return {
        "wqkv": dense(d, 3 * w),
        "conv_w": (layers._normal(generator, (CONV_K, 3 * w), device)
                   * CONV_K ** -0.5).to(dtype),
        "f_a": dense(d, r), "f_b": dense(r, w),
        "a_log": torch.log(1.0 + 15.0 * uniform((cfg.kda_heads,))),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "b": dense(d, cfg.kda_heads),
        "g_a": dense(d, r), "g_b": dense(r, w),
        "o_norm": layers.norm_init(cfg.kda_head_dim, device=device),
        "wo": dense(w, d),
    }


class KDAState(NamedTuple):
    conv: torch.Tensor       # (B, CONV_K − 1, 3·H·d_k) the conv's tail
    s: torch.Tensor          # (B, H, d_k, d_v) the delta rule's state


def init_state(cfg, batch: int, device="cpu") -> KDAState:
    """A zero state, float32."""
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    return KDAState(
        conv=torch.zeros((batch, CONV_K - 1, 3 * h * dk),
                         dtype=torch.float32, device=device),
        s=torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                      device=device))


def _l2norm_(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the last axis, in place."""
    return x.mul_(torch.rsqrt(x.square().sum(-1, keepdim=True).add_(L2_EPS)))


def to_chunks(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d) → (nc, B, H, CHUNK, d), and (B, S, n, H, d) → (n, nc,
    B, H, CHUNK, d), contiguous, in float32 (or t's wider dtype): S padded
    with zeros to a multiple of CHUNK."""
    b, s = t.shape[:2]
    nc = -(-s // CHUNK)
    if s % CHUNK:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, nc * CHUNK - s))
    t = t.reshape(b, nc, CHUNK, *t.shape[2:])
    r = t.dim()
    return t.permute(*range(3, r - 2), 1, 0, r - 2, 2, r - 1).to(
        torch.promote_types(t.dtype, torch.float32),
        memory_format=torch.contiguous_format).contiguous()


def from_chunks(t: torch.Tensor, s: int) -> torch.Tensor:
    """The reverse of ``to_chunks``: (nc, B, H, CHUNK, d) → (B, S, H, d)."""
    nc, b, h, c, d = t.shape
    return t.permute(1, 0, 3, 2, 4).reshape(b, nc * c, h, d)[:, :s]


def _inputs(p: dict, cfg, x: torch.Tensor, tail: torch.Tensor,
            chunked: bool):
    """[q / √d_k, k, v, g, β] in float32 and the conv's new tail. In
    (B, S, H, d) (β (B, S, H)), or with ``chunked`` in ``to_chunks``'s
    layout (β (…, CHUNK, 1)), each laid out and cast in one copy, the
    padding's positions inert (q = k = v = 0, g = 0)."""
    b, s, _ = x.shape
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    quant = _quant(cfg)
    qkv, new_tail = mamba2._causal_conv(layers.dense(p["wqkv"], x, quant),
                                        p["conv_w"], tail)
    f = layers.dense(p["f_b"], layers.dense(p["f_a"], x, quant), quant)
    beta = layers.dense(p["b"], x, quant)
    if chunked:
        q, k, v = to_chunks(qkv.reshape(b, s, 3, h, dk)).unbind(0)
        f, beta = to_chunks(f.reshape(b, s, h, dk)), to_chunks(beta[..., None])
        a_log, dt_bias = p["a_log"][:, None, None], p["dt_bias"].reshape(
            h, 1, dk)
    else:
        qkv = qkv.to(torch.float32).reshape(b, s, 3, h, dk)
        q, k, v = qkv.unbind(2)
        f, beta = f.to(torch.float32).reshape(b, s, h, dk), beta.float()
        a_log, dt_bias = p["a_log"][:, None], p["dt_bias"].reshape(h, dk)
    del qkv
    _l2norm_(q).mul_(dk ** -0.5)
    _l2norm_(k)
    g = F.softplus(f.add_(dt_bias)).mul_(-torch.exp(a_log))
    if chunked and s % CHUNK:
        g[-1, :, :, s % CHUNK - CHUNK:] = 0.0
    return [q, k, v, g, torch.sigmoid(beta)], new_tail.to(torch.float32)


def _scan(q, k, v, g, beta, s0):
    """The rule one position at a time. q (scaled), k, v, g: (B, S, H, d);
    β: (B, S, H); s0: (B, H, d_k, d_v) → (o (B, S, H, d_v), the last
    state)."""
    outs = []
    s = s0
    for t in range(q.shape[1]):
        s = torch.exp(g[:, t])[..., None] * s
        kt = k[:, t, :, None, :]                              # (B,H,1,dk)
        u = beta[:, t, :, None, None] * (v[:, t, :, None, :] - kt @ s)
        s = s + kt.transpose(-1, -2) @ u
        outs.append((q[:, t, :, None, :] @ s)[:, :, 0])
    return torch.stack(outs, dim=1), s


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the same leading dims, as one ``bmm`` on views: an
    operand transposed in its last two dims is read in place (a batched
    ``matmul`` would copy it)."""
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.view(*a.shape[:-1], b.shape[-1])


def _diag_blocks(t: torch.Tensor, bs: int) -> torch.Tensor:
    """The diagonal blocks of bs × bs of t (…, n, n), as a view (…, n/bs,
    bs, bs)."""
    m = t.shape[-1] // bs
    return torch.diagonal(t.unflatten(-2, (m, bs)).unflatten(-1, (m, bs)),
                          0, -4, -2).movedim(-1, -3)


def _fill(a, p, k, q, g, blocks):
    """Write ``_decayed_products`` of k and q into the views a and p (…, n,
    n): the blocks of ``blocks[0]`` against the blocks before them,
    factored about the last position before the block, then each diagonal
    block at the next level, and at the last the sub-diagonals."""
    n = k.shape[-2]
    if not blocks:
        torch.diagonal(p, 0, -2, -1).copy_((q * k).sum(-1))
        for dlt in range(1, n):
            ke = k[..., :n - dlt, :] * torch.exp(g[..., dlt:, :]
                                                 - g[..., :n - dlt, :])
            torch.diagonal(a, -dlt, -2, -1).copy_(
                (k[..., dlt:, :] * ke).sum(-1))
            torch.diagonal(p, -dlt, -2, -1).copy_(
                (q[..., dlt:, :] * ke).sum(-1))
        return
    bs = blocks[0]
    for i in range(1, n // bs):
        ref = g[..., i * bs - 1:i * bs, :]        # last position before
        rows, cols = slice(i * bs, (i + 1) * bs), slice(0, i * bs)
        e = torch.exp(g[..., rows, :] - ref)
        ke = (k[..., cols, :] * torch.exp(ref - g[..., cols, :])
              ).transpose(-1, -2)
        a[..., rows, cols] = _mm(k[..., rows, :] * e, ke)
        p[..., rows, cols] = _mm(q[..., rows, :] * e, ke)
    m = n // bs
    _fill(_diag_blocks(a, bs), _diag_blocks(p, bs),
          *(t.unflatten(-2, (m, bs)) for t in (k, q, g)), blocks[1:])


def _decayed_products(k, q, g):
    """k, q, g (…, C, d), g the cumulative log decay → (a, p), (…, C, C):
    a[t, j] = Σ_d k_t[d] k_j[d] e^{g_t[d] − g_j[d]} for j < t and
    p[t, j] = Σ_d q_t[d] k_j[d] e^{g_t[d] − g_j[d]} for j ≤ t, zero
    elsewhere."""
    c = k.shape[-2]
    a = k.new_zeros((*k.shape[:-2], c, c))
    p = torch.zeros_like(a)
    _fill(a, p, k, q, g, BLOCKS)
    return a, p


def _unit_lower_inverse(a: torch.Tensor) -> torch.Tensor:
    """(I + a)^{-1} for a strictly lower (…, n, n), n a power of two: the
    inverses of the diagonal blocks, doubled in size each step (T21 =
    −T22 a21 T11), as forward substitution by blocks."""
    n = a.shape[-1]
    t = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape) \
        .contiguous()
    b = 1
    while b < n:
        tv, av = _diag_blocks(t, 2 * b), _diag_blocks(a, 2 * b)
        tv[..., b:, :b] = -(tv[..., b:, b:] @ av[..., b:, :b]
                            @ tv[..., :b, :b])
        b *= 2
    return t


def _chunked(inputs: list, s0):
    """The rule CHUNK positions at a time (see the module's docstring).
    ``inputs`` = [q (scaled), k, v, g, β] in ``to_chunks``'s layout (β
    (…, CHUNK, 1)); the list is emptied, so each tensor is freed as soon
    as the algebra is done with it. → (o in that layout, the last
    state)."""
    q, k, v, g, beta = inputs
    inputs.clear()
    nc, b, h, c, dk = q.shape
    dv = v.shape[-1]
    g = g.cumsum_(-2)                                  # G, inclusive
    glast = g[..., -1:, :].clone()
    a, p = _decayed_products(k, q, g)
    t = _unit_lower_inverse(a.mul_(beta))              # (I + A)^{-1}
    del a
    eg = torch.exp(g)
    w = _mm(t, (eg * k).mul_(beta))
    u0 = _mm(t, v.mul_(beta))
    del t, v, beta
    o = _mm(p, u0)
    qeff = eg.mul_(q).sub_(_mm(p, w))
    del p, q, eg
    khat = k.mul_(torch.exp(g.neg_().add_(glast))).transpose(-1, -2)
    del g
    step_m = _mm(khat, w).neg_()                       # (nc,B,H,dk,dk)
    step_m.diagonal(0, -2, -1).add_(torch.exp(glast[..., 0, :]))
    step_n = _mm(khat, u0)                             # (nc,B,H,dk,dv)
    del khat, k, w, u0

    # the state entering each chunk, chunk by chunk
    bh = b * h
    states = torch.empty((nc, b, h, dk, dv), dtype=o.dtype, device=o.device)
    states[0].copy_(s0)
    for n in range(nc - 1):
        torch.baddbmm(step_n[n].view(bh, dk, dv), step_m[n].view(bh, dk, dk),
                      states[n].view(bh, dk, dv),
                      out=states[n + 1].view(bh, dk, dv))
    s_fin = torch.baddbmm(step_n[-1].view(bh, dk, dv),
                          step_m[-1].view(bh, dk, dk),
                          states[-1].view(bh, dk, dv)).view(b, h, dk, dv)
    del step_m, step_n
    return o.add_(_mm(qeff, states)), s_fin


def kda_forward(p: dict, cfg, x: torch.Tensor, state: KDAState
                ) -> tuple[torch.Tensor, KDAState]:
    """x: (B, S, D) → (y, new state): ``_scan`` for one position (a decode
    step), ``_chunked`` otherwise."""
    b, sl, _ = x.shape
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    quant = _quant(cfg)
    marks = x.is_cuda
    chunked = sl > 1
    with trace.span("kda.proj", device=marks):
        inputs, tail = _inputs(p, cfg, x, state.conv, chunked)
    with trace.span("kda.scan", device=marks):
        s0 = state.s.to(torch.float32)
        if chunked:
            o, s_fin = _chunked(inputs, s0)
            o = from_chunks(o, sl)
        else:
            o, s_fin = _scan(*inputs, s0)
        del inputs
    with trace.span("kda.out", device=marks):
        o = layers.apply_norm(p["o_norm"], o)                 # per head
        gate = layers.dense(p["g_b"], layers.dense(p["g_a"], x, quant),
                            quant)
        o = (o.reshape(b, sl, h * dk)
             * torch.sigmoid(gate.to(torch.float32))).to(x.dtype)
        y = layers.dense(p["wo"], o, quant)
    return y, KDAState(conv=tail, s=s_fin)
