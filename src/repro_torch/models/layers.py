"""Shared layers of the LM zoo (counterpart of ``repro/models/layers.py``):
norms, RoPE, MLPs, embeddings and the quant-aware ``dense``.

Parameters are plain nested dicts of tensors with the reference's keys, and
every weight matrix is (in_features, out_features), as in the reference, so
a parameter tree crosses between the two packages unchanged
(``models/transformer.py::params_from_numpy``).

The paper's technique enters through ``dense``:

* quant="none"            → plain matmul in the activations' dtype;
* quant="binary"          → activations and weights binarized, α-scaled;
* quant="binary_weights"  → ±1 weights with a per-channel α, real
  activations;
* a ``{"w_packed", "alpha"}`` dict (``dense_packed_from``,
  ``serve/packing.py``) → packed ±1 weights unpacked in-graph, whatever
  the quant mode. As in the reference, that product is a plain matmul
  outside any kernel.

Init takes a ``torch.Generator``; its numbers differ from ``jax.random``'s,
so parity runs hand both packages the same numpy parameters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.core.binarize import binarize_ste


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """float32 N(0, 1) drawn on the generator's device, then moved."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.to(device)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    w = _normal(generator, (d_in, d_out), device) * d_in ** -0.5
    return {"w": w.to(dtype)}


def dense_packed_init(generator: torch.Generator, d_in: int, d_out: int,
                      dtype=torch.bfloat16, device="cpu") -> dict:
    """Packed-layout init: random (out, in/32) int32 sign words and α of
    ones (builds serving trees of the right shapes; ``dtype`` is unused,
    as in the reference)."""
    words = bitpack.packed_len(d_in)
    w_packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (d_out, words),
                             generator=generator, dtype=torch.int32,
                             device=generator.device).to(device)
    return {"w_packed": w_packed,
            "alpha": torch.ones((d_out,), dtype=torch.float32,
                                device=device)}


def dense_packed_from(w: torch.Tensor) -> dict:
    """Fold a trained (in, out) weight into the packed serving form:
    (out, in/32) int32 sign words and the per-output α = mean |w|."""
    w32 = w.to(torch.float32)
    return {"w_packed": bitpack.pack_pm1(w32.T),
            "alpha": w32.abs().mean(dim=0)}


# ---------------------------------------------------------------------------
# the quant-aware matmul
# ---------------------------------------------------------------------------

def dense(p: dict, x: torch.Tensor, quant: str = "none") -> torch.Tensor:
    """x: (..., in) → (..., out), honoring the quant mode / param layout.

    A stacked weight (E, in, out) (``models/moe.py``'s experts) takes x of
    shape (E, M, in) and gives (E, M, out); each expert's α is the mean
    |w| over its own d_in, as the reference's ``vmap`` over E computes it.
    A stacked packed artifact, (E, out, in/32) words with (E, out) α, is
    applied the same way, expert by expert.
    """
    if "w_packed" in p:
        k = x.shape[-1]
        w_pm1 = bitpack.decode_pm1(bitpack.unpack_bits(p["w_packed"], k),
                                   torch.float32)
        # ±1 products are exact in float32: the reference's f32-accumulated
        # dot_general
        y = torch.matmul(x.to(torch.float32), w_pm1.transpose(-1, -2))
        alpha = p["alpha"].to(torch.float32)
        if alpha.dim() > 1:                       # (E, out) → (E, 1, out)
            alpha = alpha.unsqueeze(-2)
        return (y * alpha).to(x.dtype)

    w = p["w"]
    if quant == "none":
        return x @ w.to(x.dtype)
    if quant not in ("binary_weights", "binary"):
        raise ValueError(f"unknown quant mode {quant!r}")
    w32 = w.to(torch.float32)
    alpha = w32.abs().mean(dim=-2, keepdim=w.dim() == 3)
    x32 = x.to(torch.float32)
    if quant == "binary":
        x32 = binarize_ste(x32)
    return (x32 @ binarize_ste(w32) * alpha).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, norm_type: str = "rmsnorm", device="cpu") -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, norm_type: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, math in float32, result in
    x's dtype."""
    xf = x.to(torch.float32)
    if norm_type == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotation. x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (.., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (.., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, d_ff: int,
             mlp_type: str = "swiglu", dtype=torch.bfloat16,
             device="cpu") -> dict:
    p = {"wi": dense_init(generator, d, d_ff, dtype, device)}
    if mlp_type == "swiglu":
        p["wg"] = dense_init(generator, d, d_ff, dtype, device)
    p["wo"] = dense_init(generator, d_ff, d, dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, mlp_type: str = "swiglu",
              quant: str = "none") -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(dense(p["wg"], x, quant)) * dense(p["wi"], x, quant)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["wi"], x, quant), approximate="tanh")
    return dense(p["wo"], h, quant)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    e = _normal(generator, (vocab, d), device) * 0.02
    return {"embedding": e.to(dtype)}


def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def logits_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Final projection: per the paper, the output layer is not binarized."""
    return dense(p, x, "none")
