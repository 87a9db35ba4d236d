"""XNOR LM, deployment half (counterpart of ``repro/models/xnor_lm.py``).

A small pre-norm transformer whose every projection (Q/K/V/O, MLP up and
down) is a packed ±1 binary linear layer with its batch norm folded
(paper eq. 4/5/8), over a float32 residual stream, RMSNorm, softmax
attention, learned absolute positions and a float logit head. The MLP
hidden activation is fully binary (eq. 8 NormBinarize); every other
projection keeps its BN output in float.

Two kernel modes give the same integer agree-counts y_l (eq. 5), so the
same logits bit for bit:

* ``mode="xnor"`` packs the ±1 activations and calls
  ``kernels/ops.py::xnor_matmul`` (K1 on path "vpu", K2 on "mxu");
* ``mode="bw"`` feeds the ±1 float activations to
  ``kernels/ops.py::binary_weight_matmul`` (K6), the decode default; its
  y_lo = Σ a·w is an integer-valued float, and y_l = (y_lo + k) / 2.

Serving: ``decode_step`` advances a per-slot KV cache by one token;
``XnorLMServeModel`` plugs it into ``serve/engine.py::ServingEngine``.
Unlike the reference, which returns new immutable state, the step
updates the caches and lengths in place. A weight hot-swap copies the new
weights into the live tensors (``ServingEngine.swap_params``), so every
weight keeps its storage.

Training: ``forward_train`` runs every projection through
``core/blinear.py::apply_train`` (STE binarize, a ±1 float32 matmul,
BN); its integer-valued products equal the packed agree-counts, and the
float spine is the same sequence of ops, so eager ``forward_train`` is
bitwise equal to ``forward_packed`` in either mode (the reference's
contract). ``loss_fn`` is its next-token cross-entropy, differentiable
through the STEs. No optimizer loop is wired to it yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitpack, blinear
from repro_torch.core.binarize import binarize_ste
from repro_torch.core.blinear import BLinearParams
from repro_torch.core.execution_plan import resolve_device
from repro_torch.core.normbinarize import (BNParams, NBThreshold,
                                           fold_threshold, norm_binarize,
                                           norm_only)
from repro_torch.kernels import ops

NEG_INF = -1e30
MODES = ("bw", "xnor")


# --------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class XnorLMConfig:
    """Shape of a binarized transformer LM (a copy of the reference's).

    ``d_model``/``d_ff`` must be multiples of 32 so activations bit-pack
    without padding (``core/bitpack.py::PACK``); the weights' reduction
    axes are these same dims.
    """
    vocab_size: int = 256
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 2
    d_ff: int = 128
    max_len: int = 128

    def __post_init__(self):
        if self.d_model % bitpack.PACK:
            raise ValueError(f"d_model must be a multiple of {bitpack.PACK} "
                             f"(bit-packed reduction axis), got {self.d_model}")
        if self.d_ff % bitpack.PACK:
            raise ValueError(f"d_ff must be a multiple of {bitpack.PACK} "
                             f"(bit-packed reduction axis), got {self.d_ff}")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# --------------------------------------------------------------------- params
class XnorBlockParams(NamedTuple):
    ln1: torch.Tensor                 # (d,) rmsnorm scale, attention branch
    wq: BLinearParams
    wk: BLinearParams
    wv: BLinearParams
    wo: BLinearParams
    ln2: torch.Tensor                 # (d,) rmsnorm scale, MLP branch
    w_up: BLinearParams               # d → d_ff, binary output (eq. 8)
    w_down: BLinearParams             # d_ff → d, float BN output


class XnorLMParams(NamedTuple):
    tok_embed: torch.Tensor           # (vocab, d)
    pos_embed: torch.Tensor           # (max_len, d) learned absolute
    blocks: tuple                     # n_layers × XnorBlockParams
    ln_f: torch.Tensor                # (d,) final rmsnorm scale
    w_head: torch.Tensor              # (d, vocab) float logit head


class BProjPacked(NamedTuple):
    """One projection's deployment form: packed weight words, the BN
    statistics (float-output sites) and the folded eq. 8 threshold
    (binary-output sites). ``k`` and the BN ``eps`` are statics."""
    w_words: torch.Tensor             # (out, k//32) int32
    bn: BNParams
    thr: NBThreshold
    k: int


class XnorBlockPacked(NamedTuple):
    ln1: torch.Tensor
    wq: BProjPacked
    wk: BProjPacked
    wv: BProjPacked
    wo: BProjPacked
    ln2: torch.Tensor
    w_up: BProjPacked
    w_down: BProjPacked


class XnorLMPacked(NamedTuple):
    tok_embed: torch.Tensor
    pos_embed: torch.Tensor
    blocks: tuple                     # n_layers × XnorBlockPacked
    ln_f: torch.Tensor
    w_head: torch.Tensor


_PROJS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
_BN_FIELDS = ("bn_mean", "bn_var", "bn_gamma", "bn_beta")


def _proj_shapes(cfg: XnorLMConfig) -> dict:
    """(out, in) of each projection."""
    d, f = cfg.d_model, cfg.d_ff
    return {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
            "w_up": (f, d), "w_down": (d, f)}


def init(cfg: XnorLMConfig, generator: torch.Generator) -> XnorLMParams:
    """Latent params with the reference ``init``'s distributions (its
    numbers differ: ``jax.random`` and ``torch.Generator`` are different
    streams). Binary weights uniform in [−1, 1], BN at identity,
    embeddings N(0, 0.02²), head N(0, 1/d)."""
    d = cfg.d_model

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def blin(o: int, i: int) -> BLinearParams:
        return BLinearParams(
            w=torch.rand((o, i), generator=generator) * 2.0 - 1.0,
            bn_mean=torch.zeros(o), bn_var=torch.ones(o),
            bn_gamma=torch.ones(o), bn_beta=torch.zeros(o))

    shapes = _proj_shapes(cfg)
    blocks = tuple(XnorBlockParams(
        ln1=torch.ones(d), ln2=torch.ones(d),
        **{p: blin(*shapes[p]) for p in _PROJS})
        for _ in range(cfg.n_layers))
    return XnorLMParams(tok_embed=normal(cfg.vocab_size, d) * 0.02,
                        pos_embed=normal(cfg.max_len, d) * 0.02,
                        blocks=blocks, ln_f=torch.ones(d),
                        w_head=normal(d, cfg.vocab_size) * d ** -0.5)


def numpy_params(cfg: XnorLMConfig, seed: int) -> XnorLMParams:
    """Latent params as numpy float32 arrays made from ``seed``: the shared
    input of parity runs (tests hand the same arrays to the reference).
    BN statistics sit at the scale of each projection's ±1 pre-activation
    (variance ≈ fan-in), γ takes both signs so flipped comparators occur,
    and the RMSNorm scales are random."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def f32(x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def blin(o: int, i: int) -> BLinearParams:
        return BLinearParams(
            w=f32(rng.uniform(-1.0, 1.0, (o, i))),
            bn_mean=f32(rng.normal(0.0, 0.3 * np.sqrt(i), o)),
            bn_var=f32(rng.uniform(0.5, 2.0, o) * i),
            bn_gamma=f32(rng.uniform(0.5, 1.5, o) * rng.choice([-1.0, 1.0], o)),
            bn_beta=f32(rng.normal(0.0, 0.3, o)))

    shapes = _proj_shapes(cfg)
    blocks = tuple(XnorBlockParams(
        ln1=f32(rng.uniform(0.5, 1.5, d)), ln2=f32(rng.uniform(0.5, 1.5, d)),
        **{p: blin(*shapes[p]) for p in _PROJS})
        for _ in range(cfg.n_layers))
    return XnorLMParams(
        tok_embed=f32(rng.normal(0.0, 0.02, (cfg.vocab_size, d))),
        pos_embed=f32(rng.normal(0.0, 0.02, (cfg.max_len, d))),
        blocks=blocks, ln_f=f32(rng.uniform(0.5, 1.5, d)),
        w_head=f32(rng.normal(0.0, d ** -0.5, (d, cfg.vocab_size))))


def params_from_numpy(params) -> XnorLMParams:
    """Latent params whose leaves are numpy arrays (the reference's
    ``XnorLMParams`` mapped to numpy, or ``numpy_params``) → this port's
    ``XnorLMParams`` of CPU float32 tensors. Read by attribute."""
    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.float32))

    def blin(p) -> BLinearParams:
        return BLinearParams(**{f: t(getattr(p, f))
                                for f in ("w",) + _BN_FIELDS})

    blocks = tuple(XnorBlockParams(
        ln1=t(b.ln1), ln2=t(b.ln2), **{p: blin(getattr(b, p)) for p in _PROJS})
        for b in params.blocks)
    return XnorLMParams(tok_embed=t(params.tok_embed),
                        pos_embed=t(params.pos_embed), blocks=blocks,
                        ln_f=t(params.ln_f), w_head=t(params.w_head))


def fold(cfg: XnorLMConfig, params: XnorLMParams) -> XnorLMPacked:
    """Deployment build: pack every projection's weights (eq. 4) and fold
    its BN into the eq. 8 threshold (host float64,
    ``core/normbinarize.py::fold_threshold``)."""

    def fold_proj(p: BLinearParams) -> BProjPacked:
        k = p.w.shape[1]
        bn = BNParams(p.bn_mean, p.bn_var, p.bn_gamma, p.bn_beta)
        return BProjPacked(w_words=bitpack.pack_pm1(p.w), bn=bn,
                           thr=fold_threshold(bn, cnum=k), k=k)

    blocks = tuple(XnorBlockPacked(
        ln1=b.ln1, ln2=b.ln2, **{p: fold_proj(getattr(b, p)) for p in _PROJS})
        for b in params.blocks)
    return XnorLMPacked(tok_embed=params.tok_embed,
                        pos_embed=params.pos_embed, blocks=blocks,
                        ln_f=params.ln_f, w_head=params.w_head)


# --------------------------------------------------------- tree flattening
def _flatten(obj, leaves: list):
    """Structure of a tree of (named) tuples; appends its leaves."""
    if isinstance(obj, tuple):
        return type(obj), tuple(_flatten(x, leaves) for x in obj)
    leaves.append(obj)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    cls, children = spec
    items = [_unflatten(c, it) for c in children]
    return cls(*items) if hasattr(cls, "_fields") else cls(items)


# ------------------------------------------------------------ shared fp spine
def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + 1e-6) * scale


def _attn_full(cfg: XnorLMConfig, q, k, v) -> torch.Tensor:
    """Causal softmax attention, (B, S, H, hd) → (B, S, H, hd), float32."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg.head_dim ** -0.5
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    sc = torch.where(mask[None, None], sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _block(cfg: XnorLMConfig, blk, x: torch.Tensor, proj, attn) -> torch.Tensor:
    """One pre-norm block over a projection callback ``proj(pp, a_pm1,
    out)`` (``out`` "fp" or "pm1") and an attention ``attn(q, k, v)``."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    a = binarize_ste(_rms(x, blk.ln1))                       # ±1 (eq. 4)
    q = proj(blk.wq, a, "fp").reshape(b, s, h, hd)
    k = proj(blk.wk, a, "fp").reshape(b, s, h, hd)
    v = proj(blk.wv, a, "fp").reshape(b, s, h, hd)
    ctx = attn(q, k, v).reshape(b, s, d)
    x = x + proj(blk.wo, binarize_ste(ctx), "fp")
    u = proj(blk.w_up, binarize_ste(_rms(x, blk.ln2)), "pm1")  # binary hidden
    return x + proj(blk.w_down, u, "fp")


def _head(packed, x: torch.Tensor) -> torch.Tensor:
    return _rms(x, packed.ln_f) @ packed.w_head


# ------------------------------------------------------------- train forward
def _proj_train(p: BLinearParams, a_pm1, out: str) -> torch.Tensor:
    return blinear.apply_train(p, a_pm1, binarize_out=(out == "pm1"))


def forward_train(cfg: XnorLMConfig, params: XnorLMParams,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Differentiable STE forward: (B, S) int tokens → (B, S, vocab)
    float32 logits, on the tensors' device."""
    b, s = tokens.shape
    x = params.tok_embed[tokens] + params.pos_embed[:s][None]
    for blk in params.blocks:
        x = _block(cfg, blk, x, _proj_train,
                   lambda q, k, v: _attn_full(cfg, q, k, v))
    return _head(params, x)


def loss_fn(cfg: XnorLMConfig, params: XnorLMParams, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward_train``'s logits."""
    logp = torch.log_softmax(forward_train(cfg, params, tokens), dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None].long()))


# ------------------------------------------------------------ packed forward
def _agree_counts(pp: BProjPacked, a_pm1: torch.Tensor, *, mode: str,
                  path: str) -> torch.Tensor:
    """Integer agree-counts y_l (eq. 5) from ±1 activations, either mode.

    "xnor": sign bits → bit-pack → XNOR matmul (both operands 1-bit).
    "bw":   ±1 float activations × packed weights (K6); y_lo is an
            integer-valued float and y_l = (y_lo + k) / 2 exactly (the
            cast truncates, as the reference's ``astype`` does).
    """
    if mode == "xnor":
        words = bitpack.pack_bits(bitpack.encode_pm1(a_pm1))
        return ops.xnor_matmul(words, pp.w_words, k=pp.k, path=path)
    if mode != "bw":
        raise ValueError(f"unknown kernel mode {mode!r}; use one of {MODES}")
    y_lo = ops.binary_weight_matmul(a_pm1, pp.w_words, k=pp.k)
    return ((y_lo + pp.k) * 0.5).to(torch.int32)


def _make_proj_packed(mode: str, path: str):
    def proj(pp: BProjPacked, a_pm1, out: str) -> torch.Tensor:
        y_l = _agree_counts(pp, a_pm1, mode=mode, path=path)
        if out == "pm1":
            return bitpack.decode_pm1(norm_binarize(y_l, pp.thr))
        return norm_only(y_l, pp.bn, pp.k)
    return proj


def forward_packed(cfg: XnorLMConfig, packed: XnorLMPacked,
                   tokens: torch.Tensor, *, mode: str = "xnor",
                   path: str = "mxu") -> torch.Tensor:
    """Deployment full-sequence forward (prefill, batch scoring):
    (B, S) int tokens → (B, S, vocab) float32 logits, on the tensors'
    device. Both modes give the same logits bit for bit."""
    b, s = tokens.shape
    x = packed.tok_embed[tokens] + packed.pos_embed[:s][None]
    proj = _make_proj_packed(mode, path)
    for blk in packed.blocks:
        x = _block(cfg, blk, x, proj,
                   lambda q, k, v: _attn_full(cfg, q, k, v))
    return _head(packed, x)


# ------------------------------------------------------------- decode / serve
class XnorServeState(NamedTuple):
    """Per-slot decode state: float KV caches + per-slot filled length.
    ``decode_step`` and ``XnorLMServeModel.reset_slot`` update it in
    place."""
    k_cache: torch.Tensor             # (L, B, max_len, H, hd) float32
    v_cache: torch.Tensor             # (L, B, max_len, H, hd) float32
    length: torch.Tensor              # (B,) int64


def init_serve_state(cfg: XnorLMConfig, batch: int, max_len: int,
                     device="cpu") -> XnorServeState:
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return XnorServeState(
        k_cache=torch.zeros(shape, dtype=torch.float32, device=device),
        v_cache=torch.zeros(shape, dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int64, device=device))


def decode_step(cfg: XnorLMConfig, packed: XnorLMPacked,
                state: XnorServeState, tokens: torch.Tensor, *,
                mode: str = "bw", path: str = "mxu"):
    """One cached decode step: (B, 1) tokens → ((B, 1, vocab) logits,
    state). Updates ``state`` in place and returns it.

    Each slot writes its K/V at its own ``length`` and attends to
    positions ≤ ``length``, so slots at different depths share one step.
    The engine steps idle slots too, whose length keeps growing; a write
    at a length past the cache is dropped (the reference's ``mode="drop"``
    scatter) by writing the old row back at a clamped index, on the
    device and without a host sync. Positions clamp to the embedding
    table, as in the reference.
    """
    b = tokens.shape[0]
    hd = cfg.head_dim
    length = state.length
    max_len = state.k_cache.shape[2]
    proj = _make_proj_packed(mode, path)
    rows = torch.arange(b, device=tokens.device)
    pos = torch.clamp(length, max=packed.pos_embed.shape[0] - 1)
    x = packed.tok_embed[tokens[:, 0]][:, None] + packed.pos_embed[pos][:, None]
    slot = torch.clamp(length, max=max_len - 1)
    inside = (length < max_len)[:, None, None]
    valid = (torch.arange(max_len, device=tokens.device)[None, None, None, :]
             <= length[:, None, None, None])
    for li, blk in enumerate(packed.blocks):
        kc, vc = state.k_cache[li], state.v_cache[li]      # views

        def attn(q, k, v, kc=kc, vc=vc):
            kc[rows, slot] = torch.where(inside, k[:, 0], kc[rows, slot])
            vc[rows, slot] = torch.where(inside, v[:, 0], vc[rows, slot])
            sc = torch.einsum("bqhd,bshd->bhqs", q, kc) * hd ** -0.5
            w = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
            return torch.einsum("bhqs,bshd->bqhd", w, vc)

        x = _block(cfg, blk, x, proj, attn)
    logits = _head(packed, x)
    length.add_(1)
    return logits, state


def greedy_decode(cfg: XnorLMConfig, packed: XnorLMPacked,
                  prompt: list[int], n_steps: int, *, mode: str = "bw",
                  path: str = "mxu", max_len: int | None = None) -> list[int]:
    """Greedy reference loop: feed the prompt through ``decode_step``
    one token at a time (what the slot engine does), then generate
    ``n_steps`` tokens, on the packed tensors' device."""
    device = packed.tok_embed.device
    state = init_serve_state(cfg, 1, max_len or cfg.max_len, device)
    out: list[int] = []
    toks = list(prompt)
    for i in range(len(prompt) + n_steps - 1):
        tok = torch.tensor([[toks[i] if i < len(toks) else out[-1]]],
                           dtype=torch.int64, device=device)
        logits, state = decode_step(cfg, packed, state, tok, mode=mode,
                                    path=path)
        if i >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
    return out


# --------------------------------------------------- static/array split, swap
def split_packed(packed: XnorLMPacked):
    """(tensor leaves, rebuild closure): the tensors are the weights the
    engine holds (and a hot-swap overwrites); the statics (k, BN eps) and
    the tree structure are closed over."""
    leaves: list = []
    spec = _flatten(packed, leaves)
    mask = tuple(isinstance(x, torch.Tensor) for x in leaves)
    arrays = tuple(x for x, m in zip(leaves, mask) if m)
    statics = tuple(None if m else x for x, m in zip(leaves, mask))

    def rebuild(arrs) -> XnorLMPacked:
        it = iter(arrs)
        return _unflatten(spec, iter(
            [next(it) if m else s for m, s in zip(mask, statics)]))

    return arrays, rebuild


def assert_swap_compatible(old: XnorLMPacked, new: XnorLMPacked) -> tuple:
    """Check that ``new`` can replace ``old`` in a live engine (same
    structure, statics, shapes and dtypes); returns the new tensors in
    ``split_packed`` order. Raises ValueError otherwise."""
    lo, ln = [], []
    so, sn = _flatten(old, lo), _flatten(new, ln)
    if so != sn:
        raise ValueError(f"packed tree structure differs: {so} != {sn}")
    for i, (a, b) in enumerate(zip(lo, ln)):
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if ta != tb:
            raise ValueError(f"leaf {i}: array/static kind mismatch "
                             f"({type(a).__name__} vs {type(b).__name__})")
        if ta:
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"leaf {i}: shape/dtype mismatch {tuple(a.shape)}/"
                    f"{a.dtype} vs {tuple(b.shape)}/{b.dtype}: a swap must "
                    f"come from fold() of identically shaped params")
        elif a != b:
            raise ValueError(f"leaf {i}: static mismatch {a!r} != {b!r} "
                             f"(k/eps must be identical)")
    return tuple(x for x in ln if isinstance(x, torch.Tensor))


def packed_to(packed: XnorLMPacked, device) -> XnorLMPacked:
    """The same packed LM with every tensor on ``device``."""
    arrays, rebuild = split_packed(packed)
    return rebuild([t.to(device) for t in arrays])


class XnorLMServeModel:
    """``serve/engine.py::ServingEngine`` model adapter for the packed LM.

    The engine's ``params`` are copies of the tensors of ``split_packed``
    on the model's device (a swap overwrites them, never the caller's
    packed net); ``decode_step`` rebuilds the packed tree around them on
    every call, so tensors copied in by ``ServingEngine.swap_params`` take
    effect on the next step.
    """
    def __init__(self, cfg: XnorLMConfig, packed: XnorLMPacked, *,
                 mode: str = "bw", path: str = "mxu", plan=None,
                 device="cuda"):
        if plan is not None:        # an ExecutionPlan wins over the knobs
            mode, path = plan.lm_mode, plan.path
        if mode not in MODES:
            raise ValueError(f"unknown kernel mode {mode!r}; use one of "
                             f"{MODES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        arrays, self._rebuild = split_packed(packed)
        # a hot-swap overwrites these in place: copies, never the caller's
        self.arrays = tuple(t.to(self.device, copy=True) for t in arrays)
        self._packed_ref = packed
        self.mode, self.path = mode, path

    def init_state(self, n_slots: int, max_len: int) -> XnorServeState:
        return init_serve_state(self.cfg, n_slots, max_len, self.device)

    def decode_step(self, arrays, state, tokens):
        return decode_step(self.cfg, self._rebuild(arrays), state, tokens,
                           mode=self.mode, path=self.path)

    def reset_slot(self, state: XnorServeState, i: int,
                   n_slots: int) -> XnorServeState:
        """Zero slot ``i``'s caches and length, in place."""
        state.k_cache[:, i].zero_()
        state.v_cache[:, i].zero_()
        state.length[i] = 0
        return state

    def swap_arrays(self, new_packed: XnorLMPacked) -> tuple:
        """Check ``new_packed`` and return its tensors, on the model's
        device, for ``ServingEngine.swap_params``."""
        arrs = assert_swap_compatible(self._packed_ref, new_packed)
        self._packed_ref = new_packed
        return tuple(a.to(self.device) for a in arrs)


def make_serving_engine(cfg: XnorLMConfig, packed: XnorLMPacked, *,
                        n_slots: int = 4, max_len: int | None = None,
                        eos_id: int = -1, mode: str = "bw",
                        path: str = "mxu", plan=None, device="cuda"):
    """Packed LM → a live slot engine on ``device`` (the GPU unless
    ``device="cpu"``; raises without one). Returns ``(engine, model)``;
    keep the model for ``swap_arrays``. ``plan`` (a
    ``core/execution_plan.py::ExecutionPlan``) overrides ``mode``/``path``
    with its ``lm_mode``/``path``, e.g. the choice of
    ``kernels/autotune.py::autotune_lm_mode``."""
    from repro_torch.serve.engine import ServingEngine
    model = XnorLMServeModel(cfg, packed, mode=mode, path=path, plan=plan,
                             device=device)
    eng = ServingEngine(cfg, model.arrays, n_slots=n_slots,
                        max_len=max_len or cfg.max_len, eos_id=eos_id,
                        model=model)
    return eng, model
