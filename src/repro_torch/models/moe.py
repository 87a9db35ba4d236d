"""Mixture-of-Experts FFN of DeepSeek-V2: shared + routed experts, top-k
(counterpart of ``repro/models/moe.py``).

Dispatch is sort-based and row-local, as in the reference: each batch row
is a dispatch group with its own capacity ``capacity(S, E, k)``. A row's
(token, choice) pairs are sorted by expert (a stable sort, so ties keep
token order), each pair's rank within its expert decides whether it fits,
and the pairs that fit are written into a ``(B, E, cap, D)`` buffer; a
pair whose rank reaches ``cap`` is dropped. All E experts then run their
SwiGLU on their capacity buffers (batched matrix products over the
stacked ``(E, d_in, d_out)`` weights, or a packed serving artifact of
``serve/packing.py`` per expert, outside any kernel, as the reference's
``vmap`` of ``layers.dense`` is), and the outputs are
combined gate-weighted in float32: each token gathers its k kept
outputs and sums them in a fixed order. The
router runs in float32 on a float32 weight whatever the model's dtype;
the experts carry the linear-layer technique (``cfg.quant``), the router
does not. Every expert runs at every call, decode included.

Two settings of ``PortModelConfig`` (Kimi Linear) are chosen at the
Python level, so a softmax router over all experts launches what it
launched before them:

* ``cfg.router == "sigmoid"`` (DeepSeek-V3's ``noaux_tc`` gate): scores
  s = sigmoid(x W_r) over all experts, the top-k picked by s + b with a
  per-expert selection bias b (``router["bias"]``) that weights nothing,
  the k chosen s renormalised to sum to 1 and times
  ``cfg.routed_scale``. No aux loss (0).
* ``cfg.expert_share = (first, count)``: the layer holds the routed
  experts first .. first + count − 1 of ``cfg.n_experts`` (the share one
  chip holds under expert parallelism). It routes over all of them, with
  the capacity ``capacity(S, n_experts, k)`` of the whole layer, and
  dispatches only the pairs whose expert it holds into a (B, count,
  cap + 1, D) buffer: y is its experts' part of the result, plus the
  shared experts whole. On one chip it runs without the exchange.

``moe_apply`` is traced (``repro_torch/trace.py``) in spans with device
marks: ``moe.route`` (router and aux loss), ``moe.dispatch`` (sort,
ranks, the writes into the capacity buffer), ``moe.experts`` (the routed
experts), ``moe.combine`` (gather, gate, sum) and, where the layer has
them, ``moe.experts`` again for the shared experts and their add, and
counts the (token, choice) pairs in ``moe.pairs``, those whose expert the
layer holds in ``moe.pairs_held`` (all of them without a share), and the
held pairs dropped at capacity in ``moe.pairs_dropped``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models import layers

CAPACITY_FACTOR = 1.25


def capacity(tokens: int, n_experts: int, top_k: int,
             factor: float = CAPACITY_FACTOR) -> int:
    c = int(tokens * top_k * factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference tiles


def held(cfg) -> tuple[int, int]:
    """(first, count) of the routed experts the layer holds."""
    return tuple(cfg.expert_share) or (0, cfg.n_experts)


def moe_init(generator: torch.Generator, cfg, dtype=torch.bfloat16,
             device="cpu") -> dict:
    """The router over all ``n_experts`` (float32; with the sigmoid router
    a selection bias N(0, 0.01²) beside it) and the held experts'
    stacked weights."""
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    eh = held(cfg)[1]
    scale = d ** -0.5

    def normal(shape):
        return layers._normal(generator, shape, device) * scale

    p = {"router": {"w": normal((d, e))},             # stays float32
         "experts": {"wi": normal((eh, d, fe)).to(dtype),
                     "wg": normal((eh, d, fe)).to(dtype),
                     "wo": normal((eh, fe, d)).to(dtype)}}
    if cfg.router == "sigmoid":
        p["router"]["bias"] = layers._normal(generator, (e,), device) * 0.01
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(generator, d,
                                      cfg.n_shared_experts * fe,
                                      cfg.mlp_type, dtype, device)
    return p


def route(p: dict, cfg, x: torch.Tensor):
    """The float32 router: (probs (B, S, E), renormalised top-k gates
    (B, S, k), expert_idx (B, S, k))."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"]["w"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def route_sigmoid(p: dict, cfg, x: torch.Tensor):
    """The float32 sigmoid router: (renormalised, scaled top-k gates (B, S,
    k), expert_idx (B, S, k)), the experts picked by score + bias."""
    scores = torch.sigmoid(x.to(torch.float32) @ p["router"]["w"])
    expert_idx = torch.topk(scores + p["router"]["bias"], cfg.top_k,
                            dim=-1).indices
    gate_vals = torch.gather(scores, -1, expert_idx)
    gate_vals = gate_vals * (cfg.routed_scale
                             / gate_vals.sum(-1, keepdim=True))
    return gate_vals, expert_idx


def dispatch(expert_idx: torch.Tensor, cap: int):
    """Row-local sort-based dispatch of (B, S, k) choices: (order, sorted
    expert, sorted token, within-expert rank < cap, slot), each (B, S·k);
    ``order`` indexes the flat (token, choice) pairs of a row."""
    b, s, k = expert_idx.shape
    flat_e = expert_idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = order // k                                   # the pair's token
    ar = torch.arange(s * k, device=expert_idx.device).expand(b, -1)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    rank = ar - seg_start
    ok = rank < cap
    slot = torch.where(ok, rank, cap - 1)
    return order, se, st, ok, slot


def _wrap(w) -> dict:
    """A raw (E, d_in, d_out) expert stack or a packed artifact (dict)."""
    return w if isinstance(w, dict) else {"w": w}


def moe_apply(p: dict, cfg, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y in x's dtype, float32 aux loss). Routed top-k +
    shared experts."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    first, eh = held(cfg)
    share = eh != e
    quant = cfg.quant
    marks = x.is_cuda
    with trace.span("moe.route", device=marks):
        if cfg.router == "sigmoid":
            gate_vals, expert_idx = route_sigmoid(p, cfg, x)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            probs, gate_vals, expert_idx = route(p, cfg, x)

            # Switch-style load-balance loss over all tokens
            me = probs.mean(dim=(0, 1))
            ce = torch.zeros((e,), dtype=torch.float32,
                             device=x.device).index_add_(
                0, expert_idx.reshape(-1),
                torch.full((b * s * k,), 1.0 / (b * s * k), device=x.device))
            aux = e * torch.sum(me * ce)

    with trace.span("moe.dispatch", device=marks):
        cap = capacity(s, e, k)
        local = expert_idx
        if share:
            # the pairs of experts held elsewhere sort after the held ones,
            # under expert eh, which no buffer row holds
            local = expert_idx - first
            local = torch.where((local >= 0) & (local < eh), local, eh)
        order, se, st, ok, slot = dispatch(local, cap)
        if share:
            is_held = se < eh
            ok = ok & is_held
            se = se.clamp(max=eh - 1)
        rows = torch.arange(b, device=x.device)[:, None].expand(-1, s * k)
        # the pairs within capacity have distinct (row, expert, slot)
        # targets; a dropped pair goes to slot cap, which no expert reads
        # (the reference adds zeros at cap - 1: the same buffer, without a
        # scatter-add)
        buf = torch.zeros((b, eh, cap + 1, d), dtype=x.dtype,
                          device=x.device)
        buf.index_put_((rows, se, torch.where(ok, slot, cap)), x[rows, st])
    if trace.on():
        trace.count("moe.pairs", b * s * k)
        if share:
            n_held = is_held.sum()
            trace.count("moe.pairs_held", n_held)
            trace.count("moe.pairs_dropped", n_held - ok.sum())
        else:
            trace.count("moe.pairs_held", b * s * k)
            trace.count("moe.pairs_dropped", (~ok).sum())

    with trace.span("moe.experts", device=marks):
        # every held expert's SwiGLU on its (B·cap, D) rows, batched
        wi, wg, wo = (_wrap(p["experts"][k]) for k in ("wi", "wg", "wo"))
        hb = buf[:, :, :cap].transpose(0, 1).reshape(eh, b * cap, d)
        g = F.silu(layers.dense(wg, hb, quant))
        ob = layers.dense(wo, g * layers.dense(wi, hb, quant), quant)
        out_buf = ob.reshape(eh, b, cap, d).transpose(0, 1)     # (B,E,c,D)

    with trace.span("moe.combine", device=marks):
        # each (token, choice) pair reads its expert's output at its slot,
        # gated; a token's k choices are summed in float32
        back = torch.empty_like(order).scatter_(
            1, order, torch.arange(s * k, device=x.device).expand(b, -1))
        ok, slot = torch.gather(ok, 1, back), torch.gather(slot, 1, back)
        if share:
            local = local.clamp(max=eh - 1)
        gathered = out_buf[rows, local.reshape(b, s * k), slot]
        contrib = torch.where(ok[..., None], gathered.to(torch.float32)
                              * gate_vals.reshape(b, s * k, 1), 0)
        y = contrib.reshape(b, s, k, d).sum(dim=2).to(x.dtype)

    if "shared" in p:
        with trace.span("moe.experts", device=marks):
            y = y + layers.mlp_apply(p["shared"], x, cfg.mlp_type,
                                     quant).to(y.dtype)
    return y.to(x.dtype), aux
