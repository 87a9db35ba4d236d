"""Plain PyTorch reference of a DeepSeek-V2 prefill (arXiv:2405.04434;
huggingface.co/deepseek-ai/DeepSeek-V2-Lite), float32 with TF32 off,
one row and one layer at a time: each layer's weights are upcast when the
layer runs, so the reference fits beside a 31 GB bf16 tree. No kernels,
no cache, nothing of the program under test.

It computes the configuration as the port runs it (the departures from
the published model are listed in configs/deepseek-v2-lite-16b.json):

* RMSNorm over the last axis, eps 1e-5, times its scale.
* RoPE, half-split rotation, theta from the file, float32 angles; no YaRN.
* MLA without q-LoRA: q = x Wq split into a 128-wide "nope" part and a
  64-wide rotated part; [c_kv, k_rope] = x Wkv_a, c_kv RMS-normed, k_rope
  rotated and shared by the heads; k_nope = c_kv Wk_b, v = c_kv Wv_b;
  causal softmax(q k^T / sqrt(192)) v, then Wo.
* The first ``first_k_dense_replace`` layers: a SwiGLU FFN,
  silu(x Wg) * (x Wi) then Wo.
* The other layers: softmax router (float32 weight), greedy top-k, the k
  gates renormalised to sum to 1; a row's (token, choice) pairs taken in
  token order, each expert keeping the first ``capacity`` of them and
  dropping the rest; each expert a SwiGLU; gate-weighted sum; plus the
  shared experts as one SwiGLU of their summed width.
* final RMSNorm and the head at each row's last position.

``quant`` set to "fp8" is the control: every product (the linear layers,
q k^T and p v) takes its two operands rounded to float8 e4m3 with one
scale a tensor (amax / 448), and accumulates in float32. "bf16" rounds
each product's operands and its result to bfloat16, the precision the
configuration states: a witness of how far that precision alone moves
the logits. ``routes``, a list, collects each MoE layer's experts and
router margin at the last position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

RMS_EPS = 1e-5
CAPACITY_FACTOR = 1.25
FP8_MAX = 448.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = torch.clamp(x / s, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * s


class Plain:
    """The reference over a parameter tree in the port's layout (the
    benchmark made it from the seed; see ``h100bench/weights.py``)."""

    def __init__(self, cfg: dict, params: dict, quant: str = "none",
                 routes: list | None = None):
        self.c = cfg
        self.p = params
        self.quant = quant
        self.routes = routes

    # -- primitives -----------------------------------------------------
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.quant == "fp8":
            x, w = _fp8(x), _fp8(w)
        elif self.quant == "bf16":
            return (_bf16(x) @ _bf16(w)).to(torch.bfloat16).to(torch.float32)
        return x @ w

    @staticmethod
    def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + RMS_EPS) * scale.to(torch.float32)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x: (S, H, dr), rotated at positions 0..S-1."""
        s, dr = x.shape[0], x.shape[-1]
        inv = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(0, dr, 2, dtype=torch.float32, device=x.device)
            / dr))
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def swiglu(self, x: torch.Tensor, wi, wg, wo) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wi), wo)

    # -- blocks ---------------------------------------------------------
    def mla(self, a: dict, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        s = x.shape[0]
        h, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
        r = c["kv_lora_rank"]
        q = self.mm(x, a["wq"]["w"]).reshape(s, h, dn + dr)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:])], -1)
        ckr = self.mm(x, a["wkv_a"]["w"])
        ckv = self.rms(ckr[:, :r], a["kv_norm"]["scale"])
        k_rope = self.rope(ckr[:, None, r:])                  # (S, 1, dr)
        k_nope = self.mm(ckv, a["wk_b"]["w"]).reshape(s, h, dn)
        v = self.mm(ckv, a["wv_b"]["w"]).reshape(s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(s, h, dr)], -1)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = torch.empty(s, h, dv, dtype=torch.float32, device=x.device)
        scale = 1.0 / math.sqrt(dn + dr)
        for i in range(h):
            sc = self.mm(q[:, i], k[:, i].T) * scale
            sc = torch.where(mask, sc, float("-inf"))
            out[:, i] = self.mm(torch.softmax(sc, dim=-1), v[:, i])
        return self.mm(out.reshape(s, h * dv), a["wo"]["w"])

    def moe(self, m: dict, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        s = x.shape[0]
        e, k = c["n_routed_experts"], c["num_experts_per_tok"]
        probs = torch.softmax(x @ m["router"]["w"].to(torch.float32), -1)
        gates, idx = torch.topk(probs, k, dim=-1)
        if self.routes is not None:
            top = torch.topk(probs[-1], k + 1).values
            self.routes.append((sorted(idx[-1].tolist()),
                                float(torch.log(top[k - 1] / top[k]))))
        gates = gates / gates.sum(-1, keepdim=True)
        cap = int(s * k * CAPACITY_FACTOR / e) + 1
        cap = max(8, -(-cap // 8) * 8)
        y = torch.zeros_like(x)
        ex = m["experts"]
        for j in range(e):
            tok, choice = torch.nonzero(idx == j, as_tuple=True)  # by token
            tok, choice = tok[:cap], choice[:cap]
            if tok.numel() == 0:
                continue
            out = self.swiglu(x[tok], ex["wi"][j], ex["wg"][j], ex["wo"][j])
            y.index_add_(0, tok, out * gates[tok, choice][:, None])
        sh = m["shared"]
        return y + self.swiglu(x, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"])

    # -- the model ------------------------------------------------------
    def layers(self):
        """(kind, layer tree) of every layer, in order."""
        for key in sorted(k for k in self.p if k.startswith("stack")):
            stack = self.p[key]
            n = next(iter(_leaves(stack))).shape[0]
            kind = "moe" if key.endswith("_moe") else "dense"
            for i in range(n):
                yield kind, _map(lambda t, i=i: t[i], stack)

    def last_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (S,) int -> (vocab,) float32 logits at position S-1."""
        x = self.p["embed"]["embedding"][tokens].to(torch.float32)
        for kind, lp in self.layers():
            x = x + self.mla(lp["attn"], self.rms(x, lp["ln1"]["scale"]))
            h = self.rms(x, lp["ln2"]["scale"])
            if kind == "moe":
                x = x + self.moe(lp["moe"], h)
            else:
                m = lp["mlp"]
                x = x + self.swiglu(h, m["wi"]["w"], m["wg"]["w"],
                                    m["wo"]["w"])
        xl = self.rms(x[-1:], self.p["final_norm"]["scale"])
        return self.mm(xl, self.p["head"]["w"])[0]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def last_logits(cfg: dict, params: dict, tokens: torch.Tensor,
                quant: str = "none", routes: list | None = None
                ) -> torch.Tensor:
    """(B, S) tokens -> (B, vocab) float32 last-position logits, row by
    row, TF32 off, no grad. ``routes`` gets one list a row."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = []
            for row in tokens:
                log = None if routes is None else []
                out.append(Plain(cfg, params, quant, log).last_logits(row))
                if routes is not None:
                    routes.append(log)
            return torch.stack(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
