"""Model assembly of the LM zoo (counterpart of
``repro/models/transformer.py``).

dense | vlm : [norm → GQA attention → norm → MLP] × L; vlm prepends the
              projected patch embeddings of a stub vision frontend
moe         : [norm → MLA attention → norm → (dense MLP | shared + routed
              MoE)] × L, the first ``first_dense_layers`` with the dense MLP;
              with ``cfg.kda_layers`` (Kimi Linear) the layers of that list
              take a KDA mixer (``models/kda.py``) in MLA's place
ssm (rwkv6) : [norm → time mix → norm → channel mix] × L
hybrid      : chunks of ``attn_every`` Mamba-2 blocks, each chunk followed
(zamba2)      by ONE weight-shared GQA + MLP block (Zamba2's shared block)
audio       : a bidirectional encoder stack over the projected frame
(whisper)     embeddings of a stub frontend, and a decoder stack of
              [norm → GQA → norm → cross-attention → norm → GELU MLP] × L

Layers are weight-stacked along a leading layer axis, as in the reference
(``"stack0_dense_attn"``; moe: ``"stack0_dense_attn_mla"`` and
``"stack1_moe"``, and with KDA layers also ``"stack2_dense_kda"`` and
``"stack3_moe_kda"``; ``"stack0_rwkv"``, ``"stack0_mamba"``; audio:
``"stack0_dec_xattn"`` and the encoder's ``"enc"``), and applied by a
Python loop over the layers in the model's order (``_layer_kinds``),
each taking its row of its kind's stack, where the reference scans. Every
full-sequence self-attention goes through
``kernels/ops.py::flash_attention`` (``attention.gqa_forward`` or
``mla.mla_forward``), so on the card ``forward_train`` and ``prefill``
launch K7 once per attention layer, once per application of the
hybrid's shared block, never in the ssm family, and in the audio family
once per encoder layer (``causal=False``) and once per decoder layer.
The encoder runs in the dtype of the frames it is given, as the
reference's does (``audio_proj`` is ``frames @ w.to(frames.dtype)``):
float32 frames encode in float32 in a bf16 model. The decoder's
cross-attention stays plain (``attention.cross_attn_forward``). Serving
steps one token per slot through ``decode_step``, which updates the
per-layer caches (K/V, MLA's latents, the recurrent states, the KDA
layers' conv tails and delta-rule states beside the MLA layers' latents,
and the shared block's per-application K/V) in place.

Training: ``loss_fn`` is the reference's chunked cross-entropy
(``LOSS_CHUNK`` positions a chunk, float32 logits, each chunk under
``torch.utils.checkpoint``). Under autograd the attention takes the
blockwise plain path on every device
(``kernels/flash_attention.py::autograd_records``), so a training step
launches no K7; with ``cfg.remat`` each layer (encoder layers too) runs
under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
over its scan. A forward under ``torch.no_grad()`` is the inference
path, unchanged.

Entry points (functions of (cfg, params, …)):
    init_params   forward_hidden   forward_train   loss_fn   prefill
    init_serve_state   decode_step   params_from_numpy   numpy_params
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import (attention, kda, layers, mamba2, mla, moe,
                                rwkv6)
# tree_leaves / tree_unflatten are re-exported for callers of this module
from repro_torch.train.tree import (  # noqa: F401
    tree_leaves, tree_map, tree_unflatten)

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
KDA_KINDS = ("dense_kda", "moe_kda")


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


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
    if layer_kind == "rwkv":
        p = rwkv6.rwkv_init(generator, cfg, dt, device)
        p["ln1"] = layers.norm_init(cfg.d_model, cfg.norm_type, device)
        p["ln2"] = layers.norm_init(cfg.d_model, cfg.norm_type, device)
        return p
    if layer_kind == "mamba":
        return {"ln1": layers.norm_init(cfg.d_model, cfg.norm_type, device),
                "mamba": mamba2.mamba_init(generator, cfg, dt, device)}
    if layer_kind in KDA_KINDS:
        p = {"ln1": layers.norm_init(cfg.d_model, cfg.norm_type, device),
             "kda": kda.kda_init(generator, cfg, dt, device),
             "ln2": layers.norm_init(cfg.d_model, cfg.norm_type, device)}
        if layer_kind == "moe_kda":
            p["moe"] = moe.moe_init(generator, cfg, dt, device)
        else:
            p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_type, dt, device)
        return p
    if layer_kind not in ("dense_attn", "moe", "enc_attn", "dec_xattn"):
        raise ValueError(layer_kind)
    p = _attn_block_init(generator, cfg, dt, device)
    if layer_kind == "moe":
        p["moe"] = moe.moe_init(generator, cfg, dt, device)
        return p
    if layer_kind == "dec_xattn":      # whisper decoder: self + cross + MLP
        p["xattn"] = attention.attn_init(generator, cfg, dt, device)
        p["ln3"] = layers.norm_init(cfg.d_model, cfg.norm_type, device)
    # whisper's encoder and decoder blocks run a GELU MLP whatever
    # cfg.mlp_type says, as the reference's do
    mlp_type = cfg.mlp_type if layer_kind == "dense_attn" else "gelu"
    p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, mlp_type,
                               dt, device)
    return p


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


def _layer_kinds(cfg) -> list[str]:
    """The kind of each layer of the decoder stack, in order."""
    _check_family(cfg)
    if cfg.family == "moe" and cfg.kda_layers:
        nd = cfg.first_dense_layers
        return [("dense" if i < nd else "moe") + "_kda"
                if i + 1 in cfg.kda_layers else
                ("dense_attn_mla" if i < nd else "moe")
                for i in range(cfg.n_layers)]
    return [kind for kind, count in _layer_plan(cfg) for _ in range(count)]


def _layer_plan(cfg) -> list[tuple[str, int]]:
    """[(layer_kind, count)]: the stacks of the decoder, one a kind; in
    order of the layers, save for the moe family's KDA layers (whose
    order ``_layer_kinds`` gives)."""
    _check_family(cfg)
    if cfg.family == "moe":
        if cfg.kda_layers:
            kinds = _layer_kinds(cfg)
            return [(kind, kinds.count(kind)) for kind in
                    ("dense_attn_mla", "moe") + KDA_KINDS]
        nd = cfg.first_dense_layers
        return [("dense_attn_mla", nd), ("moe", cfg.n_layers - nd)]
    if cfg.family == "ssm":
        return [("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("mamba", cfg.n_layers)]
    if cfg.family == "audio":
        return [("dec_xattn", cfg.n_layers)]
    return [("dense_attn", cfg.n_layers)]


def _hybrid_chunks(cfg) -> tuple[int, int]:
    """(applications of the shared block, Mamba-2 layers before each).
    Raises where the layers do not split evenly, as the reference's
    reshape of the stack does."""
    every = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {every}")
    return cfg.n_layers // every, every


def init_params(cfg, generator: torch.Generator, device="cpu") -> dict:
    """The reference's ``init_params`` tree (same keys, shapes and dtypes;
    weights in the config's dtype; norm scales, the MoE router and the
    recurrent blocks' mixes, decays and biases in float32) from
    ``generator``, on ``device``. Draws happen on the
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
    if cfg.family == "hybrid":
        _hybrid_chunks(cfg)
        params["shared_attn"] = _block_init(generator, cfg, "dense_attn",
                                            device)
    if cfg.family == "vlm":
        # the stub vision frontend: one projection of precomputed patch
        # embeddings
        params["vision_proj"] = layers.dense_init(generator, cfg.d_model,
                                                  cfg.d_model, dt, device)
    if cfg.family == "audio":
        params["enc"] = _stack_init(generator, cfg, "enc_attn",
                                    cfg.n_encoder_layers, device)
        params["enc_norm"] = layers.norm_init(cfg.d_model, cfg.norm_type,
                                              device)
        # the stub conv frontend: one projection of precomputed frame
        # embeddings
        params["audio_proj"] = layers.dense_init(generator, cfg.d_model,
                                                 cfg.d_model, dt, device)
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


def _apply_rwkv(p: dict, cfg, x: torch.Tensor, st: rwkv6.RWKVState):
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    y, st = rwkv6.time_mix_forward(p["time_mix"], cfg, h, st)
    x = (x + y).to(x.dtype)
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    y, st = rwkv6.channel_mix_forward(p["channel_mix"], cfg, h, st)
    return (x + y).to(x.dtype), st


def _apply_mamba(p: dict, cfg, x: torch.Tensor, st: mamba2.MambaState):
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    y, st = mamba2.mamba_forward(p["mamba"], cfg, h, st)
    return (x + y).to(x.dtype), st


def _apply_kda(p: dict, cfg, x: torch.Tensor, st: kda.KDAState):
    """A KDA layer, its FFN dense or MoE → (x, the MoE's aux loss or None,
    the new state)."""
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    y, st = kda.kda_forward(p["kda"], cfg, h, st)
    x = x + y
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    if "moe" in p:
        y, aux = moe.moe_apply(p["moe"], cfg, h)
        return x + y, aux, st
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type, cfg.quant), None, st


def _apply_kda_step(p: dict, cfg, x: torch.Tensor, st: kda.KDAState):
    x, _, st = _apply_kda(p, cfg, x, st)
    return x, st


def _layer(stack: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stack)


def _layers(cfg, params: dict):
    """(layer kind "dense_attn" | "moe" | "dense_kda" | "moe_kda" | "rwkv"
    | "mamba" | "dec_xattn", that layer's parameters) of every layer of
    the stack, in order."""
    keys = {kind: f"stack{i}_{kind}"
            for i, (kind, _) in enumerate(_layer_plan(cfg))}
    taken = dict.fromkeys(keys, 0)
    for kind in _layer_kinds(cfg):
        j = taken[kind]
        taken[kind] += 1
        yield ("dense_attn" if kind == "dense_attn_mla" else kind,
               _layer(params[keys[kind]], j))


def _recurrent_state(cfg, batch: int, device):
    """One layer's zero recurrent state (float32): RWKVState or
    MambaState."""
    mod = rwkv6 if cfg.family == "ssm" else mamba2
    return mod.init_state(cfg, batch, device=device)


def _apply_dec_xattn(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    x = x + attention.gqa_forward(p["attn"], cfg, h, positions)
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    x = x + attention.cross_attn_forward(p["xattn"], cfg, h, enc_k, enc_v)
    h = layers.apply_norm(p["ln3"], x, cfg.norm_type)
    return x + layers.mlp_apply(p["mlp"], h, "gelu", cfg.quant)


def _remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``cfg.remat`` is set and grad mode is on: the layer's
    activations are recomputed in the backward pass, as the reference's
    ``_maybe_remat`` (``jax.checkpoint``) does. The values are the same
    either way."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _decoder_stack(cfg, params: dict, x: torch.Tensor,
                   positions: torch.Tensor, enc_kv=None):
    """Run the decoder layer stack, one layer of the stacked tree at a
    time (each under ``_remat``) → (x, the MoE layers' summed aux loss,
    float32). The recurrent families start every layer from a zero state
    (a full sequence); the hybrid applies the shared block after every
    ``attn_every`` layers; the audio family's layer i cross-attends to
    row i of ``enc_kv``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    every = _hybrid_chunks(cfg)[1] if cfg.family == "hybrid" else 0
    for i, (kind, p) in enumerate(_layers(cfg, params)):
        if kind == "dec_xattn":
            x = _remat(cfg, _apply_dec_xattn, p, cfg, x, positions,
                       enc_kv[0][i], enc_kv[1][i])
        elif kind == "moe":
            x, a = _remat(cfg, _apply_moe, p, cfg, x, positions)
            aux = aux + a
        elif kind == "rwkv":
            x, _ = _remat(cfg, _apply_rwkv, p, cfg, x,
                          _recurrent_state(cfg, x.shape[0], x.device))
        elif kind in KDA_KINDS:
            x, a, _ = _remat(cfg, _apply_kda, p, cfg, x,
                             kda.init_state(cfg, x.shape[0], x.device))
            if a is not None:
                aux = aux + a
        elif kind == "mamba":
            x, _ = _remat(cfg, _apply_mamba, p, cfg, x,
                          _recurrent_state(cfg, x.shape[0], x.device))
            if (i + 1) % every == 0:          # the weight-shared block
                x = _remat(cfg, _apply_dense_attn, params["shared_attn"],
                           cfg, x, positions)
        else:
            x = _remat(cfg, _apply_dense_attn, p, cfg, x, positions)
    return x, aux


def _apply_enc_layer(p: dict, cfg, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
    x = x + attention.gqa_forward(p["attn"], cfg, h, positions, causal=False)
    h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
    return x + layers.mlp_apply(p["mlp"], h, "gelu", cfg.quant)


def _encode(cfg, params: dict, frames: torch.Tensor):
    """The whisper encoder on stub frame embeddings (B, S_enc, D) → the
    per-decoder-layer cross K/V, each (L, B, S_enc, H, hd), in the frames'
    dtype (no cast: ``audio_proj`` runs in it, as in the reference). The
    encoder's self-attention is K7 with ``causal=False``; K/V take quant
    ``binary_weights`` where ``cfg.quant`` is ``"binary"``."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family needs a frontend "
                         f"of (B, S_enc, d_model) frame embeddings")
    x = layers.dense(params["audio_proj"], frames, "none")
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    enc = params["enc"]
    for i in range(cfg.n_encoder_layers):
        x = _remat(cfg, _apply_enc_layer, _layer(enc, i), cfg, x, pos)
    x = layers.apply_norm(params["enc_norm"], x, cfg.norm_type)
    b, se, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    quant = "binary_weights" if cfg.quant == "binary" else cfg.quant
    ks, vs = [], []
    for _, p in _layers(cfg, params):
        for w, out in ((p["xattn"]["wk"], ks), (p["xattn"]["wv"], vs)):
            t = layers.dense(w, x, quant).reshape(b, se, kvh, hd)
            out.append(attention._repeat_kv(t, h // kvh))
    return torch.stack(ks), torch.stack(vs)


class Batch(NamedTuple):
    tokens: torch.Tensor                 # (B, S) int
    targets: torch.Tensor                # (B, S) int
    frontend: torch.Tensor | None = None  # (B, P, D) stub patch (vlm) or
                                          # frame (audio) embeddings


def _head(params: dict) -> dict:
    return params.get("head", {"w": params["embed"]["embedding"].T})


def forward_hidden(cfg, params: dict, batch: Batch):
    """Full-sequence causal forward → (final hidden states, aux_loss).
    The vlm family with a ``batch.frontend`` projects the patch
    embeddings, runs them ahead of the text and drops their positions
    from the result; the audio family encodes ``batch.frontend``'s frames
    and cross-attends to them."""
    _check_family(cfg)
    x = layers.embed_lookup(params["embed"], batch.tokens)
    vision = cfg.family == "vlm" and batch.frontend is not None
    if vision:
        pe = layers.dense(params["vision_proj"], batch.frontend, "none")
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    enc_kv = (_encode(cfg, params, batch.frontend)
              if cfg.family == "audio" else None)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _decoder_stack(cfg, params, x, pos, enc_kv)
    if vision:
        x = x[:, batch.frontend.shape[1]:]               # text positions
    return layers.apply_norm(params["final_norm"], x, cfg.norm_type), aux


def forward_train(cfg, params: dict, batch: Batch):
    """Full-sequence causal forward → ((B, S, vocab) logits, aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch)
    return layers.logits_head(_head(params), x), aux


LOSS_CHUNK = 512


def _ce_chunk(head: dict, xch: torch.Tensor, tch: torch.Tensor):
    """Summed cross-entropy of one chunk: float32 logits, logsumexp minus
    the gold logit (a gather, equal to the reference's one-hot dot)."""
    logits = layers.logits_head(head, xch).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)                     # (B, chunk)
    gold = torch.gather(logits, -1, tch[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def loss_fn(cfg, params: dict, batch: Batch):
    """The reference's chunked big-vocab cross-entropy → (loss, {"nll",
    "aux"}): logits exist for one chunk of ``min(LOSS_CHUNK, S)``
    positions at a time, recomputed in the backward pass (each chunk
    under ``torch.utils.checkpoint`` when grad mode is on); positions past
    ``(S // chunk) * chunk`` are left out, as in the reference. nll is the
    mean over the positions counted; loss = nll + 0.01 · aux."""
    x, aux = forward_hidden(cfg, params, batch)
    head = _head(params)
    b, s, _ = x.shape
    chunk = min(LOSS_CHUNK, s)
    nc = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (head, x[:, sl], batch.targets[:, sl].to(x.device))
        total = total + (checkpoint(_ce_chunk, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _ce_chunk(*args))
    nll = total / (b * nc * chunk)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def prefill(cfg, params: dict, tokens: torch.Tensor,
            frontend: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence prefill → (B, 1, vocab) last-position logits (the
    cache fill is elided, as in the reference; serving feeds prompts
    through ``decode_step``). ``frontend``: the vlm family's (B, P, D)
    patch embeddings or the audio family's (B, S_enc, D) frame
    embeddings."""
    x, _ = forward_hidden(cfg, params, Batch(tokens=tokens, targets=tokens,
                                             frontend=frontend))
    return layers.logits_head(_head(params), x[:, -1:, :])


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    caches: Any                 # stacked per layer: attention.KVCache with
                                # (L, B, S_max, KV, hd) K/V, or (moe)
                                # mla.MLACache with (L, B, S_max, r) c_kv and
                                # (L, B, S_max, dr) k_rope; (L, B) lengths;
                                # (ssm) rwkv6.RWKVState, (L, B, …) float32;
                                # (hybrid) {"ssm": mamba2.MambaState (L, B,
                                # …), "shared_kv": KVCache with one cache per
                                # shared-block application, (n_chunks, B, …)};
                                # (moe with KDA layers) {"kda": kda.KDAState
                                # (L_kda, B, …), "mla": MLACache (L_mla, …)}
    enc_kv: Any                 # the audio family's cross (K, V), each
                                # (L, B, S_enc, H, hd), or None
    length: torch.Tensor        # scalar int64 — steps taken


def _stacked(per, n: int):
    """A NamedTuple of per-layer tensors → the same with a leading axis of
    n, each a contiguous copy."""
    return type(per)(*(a.expand(n, *a.shape).contiguous() for a in per))


def init_serve_state(cfg, batch: int, max_len: int,
                     device="cpu") -> ServeState:
    _check_family(cfg)
    length = torch.zeros((), dtype=torch.int64, device=device)
    if cfg.family in ("ssm", "hybrid"):
        states = _stacked(_recurrent_state(cfg, batch, device), cfg.n_layers)
        if cfg.family == "ssm":
            return ServeState(states, None, length)
        # one KV cache per application of the weight-shared block
        kv = attention.init_cache(cfg, batch, max_len, _dtype(cfg), device)
        return ServeState({"ssm": states,
                           "shared_kv": _stacked(kv, _hybrid_chunks(cfg)[0])},
                          None, length)
    cache = mla if cfg.attn_type == "mla" else attention
    per = cache.init_cache(cfg, batch, max_len, _dtype(cfg), device)
    if cfg.family == "moe" and cfg.kda_layers:
        n_kda = sum(k in KDA_KINDS for k in _layer_kinds(cfg))
        return ServeState(
            {"kda": _stacked(kda.init_state(cfg, batch, device), n_kda),
             "mla": _stacked(per, cfg.n_layers - n_kda)}, None, length)
    return ServeState(_stacked(per, cfg.n_layers), None, length)


def _recurrent_step(apply, p: dict, cfg, x: torch.Tensor, states, i: int):
    """Layer i of a recurrent stack on one token, its state (row i of the
    stacked ``states``) updated in place."""
    st = type(states)(*(a[i] for a in states))
    x, new = apply(p, cfg, x, st)
    for dst, src in zip(st, new):
        if dst is not src:
            dst.copy_(src)
    return x


def decode_step(cfg, params: dict, state: ServeState, tokens: torch.Tensor,
                frontend: torch.Tensor | None = None):
    """One decode step with a filled cache: (B, 1) tokens → ((B, 1, vocab)
    logits, state). Updates every layer's cache or recurrent state and the
    step count in place and returns the state. The recurrent families
    take their token-scan forms (a one-token forward through the stack),
    as do the moe family's KDA layers beside its MLA layers' absorbed
    decode; the hybrid's shared block attends to its own cache at each
    application. The moe family's MoE layers route every step's token
    through all experts' capacity buffers, as the reference does. The
    audio family cross-attends to ``state.enc_kv``; where that is None it
    encodes ``frontend`` first and returns a state that holds the
    result."""
    _check_family(cfg)
    x = layers.embed_lookup(params["embed"], tokens)
    if cfg.family == "audio" and state.enc_kv is None:
        state = state._replace(enc_kv=_encode(cfg, params, frontend))
    c = state.caches
    if cfg.family == "ssm":
        for i, (_, p) in enumerate(_layers(cfg, params)):
            x = _recurrent_step(_apply_rwkv, p, cfg, x, c, i)
    elif cfg.family == "hybrid":
        every = _hybrid_chunks(cfg)[1]
        shared = params["shared_attn"]
        kv = c["shared_kv"]
        for i, (_, p) in enumerate(_layers(cfg, params)):
            x = _recurrent_step(_apply_mamba, p, cfg, x, c["ssm"], i)
            if (i + 1) % every == 0:
                h = layers.apply_norm(shared["ln1"], x, cfg.norm_type)
                y, _ = attention.gqa_decode_step(
                    shared["attn"], cfg, h,
                    type(kv)(*(a[i // every] for a in kv)))
                x = x + y
                h = layers.apply_norm(shared["ln2"], x, cfg.norm_type)
                x = x + layers.mlp_apply(shared["mlp"], h, cfg.mlp_type,
                                         cfg.quant)
    else:
        step = (mla.mla_decode_step if cfg.attn_type == "mla"
                else attention.gqa_decode_step)
        # the moe family with KDA layers keeps {"kda", "mla"}: row n_kda of
        # the KDA states, row i - n_kda of the MLA caches
        kv = c["mla"] if isinstance(c, dict) else c
        n_kda = 0
        for i, (kind, p) in enumerate(_layers(cfg, params)):
            if kind in KDA_KINDS:
                x = _recurrent_step(_apply_kda_step, p, cfg, x, c["kda"],
                                    n_kda)
                n_kda += 1
                continue
            h = layers.apply_norm(p["ln1"], x, cfg.norm_type)
            y, _ = step(p["attn"], cfg, h,
                        type(kv)(*(a[i - n_kda] for a in kv)))
            x = x + y
            h = layers.apply_norm(p["ln2"], x, cfg.norm_type)
            if kind == "moe":
                x = x + moe.moe_apply(p["moe"], cfg, h)[0]
            elif kind == "dec_xattn":
                x = x + attention.cross_attn_forward(
                    p["xattn"], cfg, h, state.enc_kv[0][i],
                    state.enc_kv[1][i])
                h = layers.apply_norm(p["ln3"], x, cfg.norm_type)
                x = x + layers.mlp_apply(p["mlp"], h, "gelu", cfg.quant)
            else:
                x = x + layers.mlp_apply(p["mlp"], h, cfg.mlp_type,
                                         cfg.quant)
    state.length.add_(1)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm_type)
    return layers.logits_head(_head(params), x), state
