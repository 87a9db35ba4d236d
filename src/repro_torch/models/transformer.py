"""Model assembly of the LM zoo, dense and moe families (counterpart of
``repro/models/transformer.py``).

dense : [norm → GQA attention → norm → MLP] × L
moe   : [norm → MLA attention → norm → (dense MLP | shared + routed MoE)]
        × L, the first ``first_dense_layers`` with the dense MLP

Layers are weight-stacked along a leading layer axis, as in the reference
(``"stack0_dense_attn"``; moe: ``"stack0_dense_attn_mla"`` and
``"stack1_moe"``), and applied by a Python loop over that axis where the
reference scans. Every layer's full-sequence attention goes through
``kernels/ops.py::flash_attention`` (``attention.gqa_forward`` or
``mla.mla_forward``), so on the card ``forward_train`` and ``prefill``
launch K7 once per layer. Serving steps one token per slot through
``decode_step``, which updates the per-layer caches (K/V, or MLA's
latents) in place.

The other families (ssm, hybrid, vlm, audio) raise ``NotImplementedError``
until they are ported (ROADMAP queue 1). ``loss_fn`` is not ported: on
the card ``forward_train`` reaches K7, which has no backward (ROADMAP
queue 1). The BCNN and the XNOR LM train (``train/bcnn_train.py``,
``models/xnor_lm.py::loss_fn``).

Entry points (functions of (cfg, params, …)):
    init_params   forward_hidden   forward_train   prefill
    init_serve_state   decode_step   params_from_numpy   numpy_params
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import attention, layers, mla, moe

FAMILIES = ("dense", "moe")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port runs the dense family, see ROADMAP queue 1")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_block_init(generator: torch.Generator, cfg, dt, device) -> dict:
    if cfg.attn_type == "mla":
        attn_p = mla.mla_init(generator, cfg, dt, device)
    else:
        attn_p = attention.attn_init(generator, cfg, dt, device)
    return {"ln1": layers.norm_init(cfg.d_model, cfg.norm_type, device),
            "attn": attn_p,
            "ln2": layers.norm_init(cfg.d_model, cfg.norm_type, device)}


def _block_init(generator: torch.Generator, cfg, layer_kind: str,
                device) -> dict:
    dt = _dtype(cfg)
    p = _attn_block_init(generator, cfg, dt, device)
    if layer_kind == "dense_attn":
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_type, dt, device)
    elif layer_kind == "moe":
        p["moe"] = moe.moe_init(generator, cfg, dt, device)
    else:
        raise NotImplementedError(f"layer kind {layer_kind!r} is not ported "
                                  f"yet, see ROADMAP queue 1")
    return p


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack_init(generator: torch.Generator, cfg, layer_kind: str, n: int,
                device) -> dict:
    """Init n layers into tensors with a leading layer axis. Each layer is
    made and copied in turn, so only one unstacked layer is alive."""
    first = _block_init(generator, cfg, layer_kind, device)
    stack = tree_map(lambda a: torch.empty((n, *a.shape), dtype=a.dtype,
                                           device=a.device), first)
    layer = first
    for i in range(n):
        if i:
            layer = _block_init(generator, cfg, layer_kind, device)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, layer)
    return stack


def _layer_plan(cfg) -> list[tuple[str, int]]:
    """[(layer_kind, count)] segments of the decoder stack."""
    _check_family(cfg)
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return [("dense_attn_mla", nd), ("moe", cfg.n_layers - nd)]
    return [("dense_attn", cfg.n_layers)]


def init_params(cfg, generator: torch.Generator, device="cpu") -> dict:
    """The reference's ``init_params`` tree (same keys, shapes and dtypes;
    weights in the config's dtype, norm scales and the MoE router in
    float32) from ``generator``, on ``device``. Draws happen on the
    generator's device: pass a CUDA generator to build a full-size model
    on the card."""
    _check_family(cfg)
    dt = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dt, device),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm_type, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(generator, cfg.d_model,
                                           cfg.vocab_size, dt, device)
    for i, (kind, count) in enumerate(_layer_plan(cfg)):
        if count:
            block = "dense_attn" if kind == "dense_attn_mla" else kind
            params[f"stack{i}_{kind}"] = _stack_init(generator, cfg, block,
                                                     count, device)
    return params


def params_from_numpy(cfg, tree: dict, device="cpu") -> dict:
    """The reference's ``init_params`` tree with numpy leaves → the port's
    tree on ``device``. bfloat16 leaves (``ml_dtypes``, which
    ``torch.from_numpy`` cannot take) go through float32 to the config's
    dtype, which is lossless; every other leaf keeps its dtype."""
    _check_family(cfg)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device,
                                                              _dtype(cfg))
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(leaf, tree)


def numpy_params(tree: dict) -> dict:
    """The reverse of ``params_from_numpy``: numpy leaves on the host,
    bfloat16 as float32 (lossless), every other dtype kept."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()
    return tree_map(leaf, tree)


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The leaves of a parameter tree in a fixed (insertion) order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: dict, leaves) -> dict:
    """A tree shaped as ``like`` holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# full-sequence forward (training & prefill share it)
# ---------------------------------------------------------------------------

def _attend(p: dict, cfg, h: torch.Tensor, positions: torch.Tensor,
            causal: bool = True) -> torch.Tensor:
    if cfg.attn_type == "mla":
        return mla.mla_forward(p, cfg, h, positions, causal=causal)
    return attention.gqa_forward(p, cfg, h, positions, causal=causal)


def _apply_dense_attn(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    x = x + _attend(p["attn"], cfg, h, positions, causal)
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type, cfg.quant)


def _apply_moe(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    x = x + _attend(p["attn"], cfg, h, positions)
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    y, aux = moe.moe_apply(p["moe"], cfg, h)
    return x + y, aux


def _layer(stack: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stack)


def _layers(cfg, params: dict):
    """(layer kind "dense_attn" | "moe", that layer's parameters) of every
    layer of the stack, in order."""
    for i, (kind, count) in enumerate(_layer_plan(cfg)):
        for j in range(count):
            yield ("moe" if kind == "moe" else "dense_attn",
                   _layer(params[f"stack{i}_{kind}"], j))


def _decoder_stack(cfg, params: dict, x: torch.Tensor,
                   positions: torch.Tensor):
    """Run the decoder layer stack, one layer of the stacked tree at a
    time → (x, the MoE layers' summed aux loss, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in _layers(cfg, params):
        if kind == "moe":
            x, a = _apply_moe(p, cfg, x, positions)
            aux = aux + a
        else:
            x = _apply_dense_attn(p, cfg, x, positions)
    return x, aux


class Batch(NamedTuple):
    tokens: torch.Tensor                 # (B, S) int
    targets: torch.Tensor                # (B, S) int
    frontend: torch.Tensor | None = None  # stub patch/frame embeds (unused)


def _head(params: dict) -> dict:
    return params.get("head", {"w": params["embed"]["embedding"].T})


def forward_hidden(cfg, params: dict, batch: Batch):
    """Full-sequence causal forward → (final hidden states, aux_loss)."""
    _check_family(cfg)
    x = layers.embed_lookup(params["embed"], batch.tokens)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _decoder_stack(cfg, params, x, pos)
    return layers.apply_norm(params["final_norm"], x, cfg.norm_type), aux


def forward_train(cfg, params: dict, batch: Batch):
    """Full-sequence causal forward → ((B, S, vocab) logits, aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch)
    return layers.logits_head(_head(params), x), aux


def prefill(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence prefill → (B, 1, vocab) last-position logits (the
    cache fill is elided, as in the reference; serving feeds prompts
    through ``decode_step``)."""
    x, _ = forward_hidden(cfg, params, Batch(tokens=tokens, targets=tokens))
    return layers.logits_head(_head(params), x[:, -1:, :])


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    caches: Any                 # stacked per layer: attention.KVCache with
                                # (L, B, S_max, KV, hd) K/V, or (moe)
                                # mla.MLACache with (L, B, S_max, r) c_kv and
                                # (L, B, S_max, dr) k_rope; (L, B) lengths
    enc_kv: Any                 # cross K/V of the audio family (None here)
    length: torch.Tensor        # scalar int64 — steps taken


def init_serve_state(cfg, batch: int, max_len: int,
                     device="cpu") -> ServeState:
    _check_family(cfg)
    cache = mla if cfg.attn_type == "mla" else attention
    per = cache.init_cache(cfg, batch, max_len, _dtype(cfg), device)
    caches = type(per)(*(a.expand(cfg.n_layers, *a.shape).contiguous()
                         for a in per))
    return ServeState(caches, None,
                      torch.zeros((), dtype=torch.int64, device=device))


def decode_step(cfg, params: dict, state: ServeState, tokens: torch.Tensor):
    """One decode step with a filled cache: (B, 1) tokens → ((B, 1, vocab)
    logits, state). Updates every layer's cache and the step count in place
    and returns the same state. The moe family's MoE layers route every
    step's token through all experts' capacity buffers, as the reference
    does."""
    _check_family(cfg)
    x = layers.embed_lookup(params["embed"], tokens)
    c = state.caches
    step = (mla.mla_decode_step if cfg.attn_type == "mla"
            else attention.gqa_decode_step)
    for i, (kind, p) in enumerate(_layers(cfg, params)):
        h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
        y, _ = step(p["attn"], cfg, h, type(c)(*(a[i] for a in c)))
        x = x + y
        h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
        if kind == "moe":
            x = x + moe.moe_apply(p["moe"], cfg, h)[0]
        else:
            x = x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type, cfg.quant)
    state.length.add_(1)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_type)
    return layers.logits_head(_head(params), x), state
