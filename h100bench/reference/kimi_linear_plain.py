"""Plain PyTorch reference of a Kimi Linear prefill (arXiv:2510.26692;
huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct), float32 with
TF32 off: each layer's weights are upcast when the layer runs, so the
reference fits beside the bf16 tree. No kernels, no cache, nothing of the
program under test.

It computes the configuration as the port runs it (the departures from
the published model are listed in configs/kimi-linear-48b-a3b.json), on
the same expert share. ``c`` holds the sizes under the configuration
file's keys, the nested ``linear_attn_config`` flattened as ``kda_*``,
and ``expert_share`` = [first, count] of the experts held.

* RMSNorm over the last axis, eps 1e-5, times its scale.
* KDA (the layers of ``kda_layers``, 1-based), all rows and heads at
  once, the delta rule one token at a time:
  q̃, k̃, ṽ = x Wqkv; a causal depthwise conv of width 4 (no bias) and
  SiLU on each; q, k L2-normalised per head (eps 1e-6), q times
  1/sqrt(d_k); g = -exp(A_log[h]) softplus(x Wf_a Wf_b + dt_bias),
  alpha = exp(g); beta = sigmoid(x Wb);
  S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,
  o_t = S_t^T q_t from S_0 = 0; RMSNorm per head (eps 1e-5) times
  sigmoid(x Wg_a Wg_b), then Wo.
* MLA at the other layers, without q-LoRA and without RoPE: q = x Wq;
  [c_kv, k_pe] = x Wkv_a, c_kv RMS-normed, k_pe unrotated and shared by
  the heads; k_nope = c_kv Wk_b, v = c_kv Wv_b; causal
  softmax(q k^T / sqrt(192)) v, then Wo.
* The first ``first_k_dense_replace`` layers: a SwiGLU FFN.
* The other layers: scores s = sigmoid(x Wr) (float32 weight) over all
  ``num_experts``; the top-k picked by s + bias; gates the k chosen s
  renormalised to sum to 1, times ``routed_scaling_factor``. Only the held
  experts' pairs run: a row's pairs taken in token order, each held
  expert keeping the first ``capacity`` of them (the whole layer's
  capacity, ``drop``) and dropping the rest; each expert a SwiGLU;
  gate-weighted sum; plus the shared expert as one SwiGLU.
* final RMSNorm and the head (at each row's last position, or at every
  position).

``branch_gaps`` compares each residual branch apart (a layer's norm and
mixer, its norm and FFN, the final norm and head) on the same bfloat16
input, so that routing near-ties cannot swing what it reads.

``quant`` set to "fp8" is the control: every product of a linear layer
and of the attention takes its two operands rounded to float8 e4m3 with
one scale a tensor (amax / 448), and accumulates in float32. "bf16" rounds
each such product's operands and its result to bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

RMS_EPS = 1e-5
L2_EPS = 1e-6
CAPACITY_FACTOR = 1.25
FP8_MAX = 448.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = torch.clamp(x / s, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * s


def capacity(tokens: int, n_experts: int, k: int) -> int:
    cap = int(tokens * k * CAPACITY_FACTOR / n_experts) + 1
    return max(8, -(-cap // 8) * 8)


class Plain:
    """The reference over a parameter tree in the port's layout (the
    benchmark made it from the seed)."""

    def __init__(self, cfg: dict, params: dict, quant: str = "none",
                 drop: bool = True):
        self.c = cfg
        self.p = params
        self.quant = quant
        self.drop = drop

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

    def swiglu(self, x: torch.Tensor, wi, wg, wo) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wi), wo)

    # -- blocks ---------------------------------------------------------
    def kda(self, a: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D), every row at once."""
        c = self.c
        b, s, _ = x.shape
        h, dk = c["kda_num_heads"], c["kda_head_dim"]
        w = h * dk
        qkv = self.mm(x, a["wqkv"]["w"])
        cw = a["conv_w"].to(torch.float32)
        kw = cw.shape[0]
        xin = F.pad(qkv, (0, 0, kw - 1, 0))
        conv = sum(xin[:, i:i + s] * cw[i] for i in range(kw))
        qkv = F.silu(conv).reshape(b, s, 3, h, dk)

        def l2(t):
            return t * torch.rsqrt((t * t).sum(-1, keepdim=True) + L2_EPS)
        q = l2(qkv[:, :, 0]) / math.sqrt(dk)
        k = l2(qkv[:, :, 1])
        v = qkv[:, :, 2]
        f = self.mm(self.mm(x, a["f_a"]["w"]), a["f_b"]["w"])
        g = (-torch.exp(a["a_log"].to(torch.float32))[:, None]
             * F.softplus(f.reshape(b, s, h, dk)
                          + a["dt_bias"].to(torch.float32).reshape(h, dk)))
        beta = torch.sigmoid(self.mm(x, a["b"]["w"]))          # (B, S, H)

        # the rule token by token, (B·H) states at once, time leading
        bh = b * h

        def steps(t, d):
            return t.permute(1, 0, 2, *range(3, t.dim())).reshape(s, bh, d)
        qs, ks = steps(q, dk), steps(k, dk)
        alpha = steps(torch.exp(g), dk)[..., None]           # (S,BH,dk,1)
        bt = steps(beta[..., None], 1)[..., None]            # (S,BH,1,1)
        bv = steps(beta[..., None] * v, dk)[:, :, None, :]   # (S,BH,1,dv)
        state = torch.zeros((bh, dk, dk), dtype=torch.float32,
                            device=x.device)
        out = torch.empty((s, bh, 1, dk), dtype=torch.float32,
                          device=x.device)
        for t in range(s):
            state.mul_(alpha[t])
            kt = ks[t][:, None, :]                           # (BH,1,dk)
            u = torch.addcmul(bv[t], bt[t], torch.bmm(kt, state), value=-1)
            state.baddbmm_(kt.transpose(1, 2), u)
            torch.bmm(qs[t][:, None, :], state, out=out[t])
        o = out.reshape(s, b, h, dk).permute(1, 0, 2, 3)
        o = self.rms(o, a["o_norm"]["scale"]).reshape(b, s, w)
        gate = self.mm(self.mm(x, a["g_a"]["w"]), a["g_b"]["w"])
        return self.mm(o * torch.sigmoid(gate), a["wo"]["w"])

    def mla(self, a: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (S, D), one row."""
        c = self.c
        s = x.shape[0]
        h, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
        r = c["kv_lora_rank"]
        q = self.mm(x, a["wq"]["w"]).reshape(s, h, dn + dr)
        ckr = self.mm(x, a["wkv_a"]["w"])
        ckv = self.rms(ckr[:, :r], a["kv_norm"]["scale"])
        k_pe = ckr[:, None, r:]                                 # (S, 1, dr)
        k_nope = self.mm(ckv, a["wk_b"]["w"]).reshape(s, h, dn)
        v = self.mm(ckv, a["wv_b"]["w"]).reshape(s, h, dv)
        k = torch.cat([k_nope, k_pe.expand(s, h, dr)], -1)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = torch.empty(s, h, dv, dtype=torch.float32, device=x.device)
        scale = 1.0 / math.sqrt(dn + dr)
        for i in range(h):
            sc = self.mm(q[:, i], k[:, i].T) * scale
            sc = torch.where(mask, sc, float("-inf"))
            out[:, i] = self.mm(torch.softmax(sc, dim=-1), v[:, i])
        return self.mm(out.reshape(s, h * dv), a["wo"]["w"])

    def moe(self, m: dict, x: torch.Tensor) -> torch.Tensor:
        """x: (S, D), one row: the held experts' part and the shared
        expert."""
        c = self.c
        s = x.shape[0]
        e, k = c["num_experts"], c["num_experts_per_token"]
        first, count = c["expert_share"]
        scores = torch.sigmoid(x @ m["router"]["w"].to(torch.float32))
        idx = torch.topk(scores + m["router"]["bias"].to(torch.float32), k,
                         dim=-1).indices
        gates = torch.gather(scores, -1, idx)
        gates = gates / gates.sum(-1, keepdim=True) \
            * c["routed_scaling_factor"]
        cap = capacity(s, e, k) if self.drop else s
        y = torch.zeros_like(x)
        ex = m["experts"]
        for j in range(count):
            tok, choice = torch.nonzero(idx == first + j, as_tuple=True)
            tok, choice = tok[:cap], choice[:cap]
            if tok.numel() == 0:
                continue
            out = self.swiglu(x[tok], ex["wi"][j], ex["wg"][j], ex["wo"][j])
            y.index_add_(0, tok, out * gates[tok, choice][:, None])
        sh = m["shared"]
        return y + self.swiglu(x, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"])

    # -- the model ------------------------------------------------------
    def layers(self):
        """(mixer "kda" | "mla", FFN "dense" | "moe", layer tree) of every
        layer, in order: layer i (1-based) mixes by KDA where
        ``kda_layers`` holds i, and keeps a dense FFN while i <=
        ``first_k_dense_replace``. The port stacks each kind under a key
        ``stack<n>_<kind>``."""
        c = self.c
        stacks = {key.split("_", 1)[1]: self.p[key]
                  for key in self.p if key.startswith("stack")}
        taken: dict = {}
        for i in range(1, c["num_hidden_layers"] + 1):
            mixer = "kda" if i in c["kda_layers"] else "mla"
            ffn = "dense" if i <= c["first_k_dense_replace"] else "moe"
            kind = {("kda", "dense"): "dense_kda", ("kda", "moe"): "moe_kda",
                    ("mla", "dense"): "dense_attn_mla",
                    ("mla", "moe"): "moe"}[mixer, ffn]
            j = taken.get(kind, 0)
            taken[kind] = j + 1
            yield mixer, ffn, _map(lambda t, j=j: t[j], stacks[kind])

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"]["embedding"][tokens].to(torch.float32)

    def norm(self, x: torch.Tensor, scale: torch.Tensor,
             rounded: bool) -> torch.Tensor:
        """RMSNorm, its output rounded to bfloat16 where ``rounded``."""
        h = self.rms(x, scale)
        return _bf16(h) if rounded else h

    def mixer(self, kind: str, lp: dict, x: torch.Tensor,
              rounded: bool = False) -> torch.Tensor:
        """A layer's first residual branch on the stream x (B, S, D): its
        norm and its KDA ("kda") or MLA mixer."""
        h = self.norm(x, lp["ln1"]["scale"], rounded)
        if kind == "kda":
            return self.kda(lp["kda"], h)
        return torch.stack([self.mla(lp["attn"], r) for r in h])

    def ffn(self, kind: str, lp: dict, x: torch.Tensor,
            rounded: bool = False) -> torch.Tensor:
        """A layer's second residual branch: its norm and its MoE ("moe")
        or dense SwiGLU."""
        h = self.norm(x, lp["ln2"]["scale"], rounded)
        if kind == "moe":
            return torch.stack([self.moe(lp["moe"], r) for r in h])
        m = lp["mlp"]
        return self.swiglu(h, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"])

    def head(self, x: torch.Tensor, rounded: bool = False) -> torch.Tensor:
        """The final norm and the head on the stream x."""
        return self.logits(self.norm(x, self.p["final_norm"]["scale"],
                                     rounded))

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int → (B, S, D) float32 after the final norm."""
        x = self.embed(tokens)
        for mixer, ffn, lp in self.layers():
            x = x + self.mixer(mixer, lp, x)
            x = x + self.ffn(ffn, lp, x)
        return self.rms(x, self.p["final_norm"]["scale"])

    def logits(self, xl: torch.Tensor) -> torch.Tensor:
        return self.mm(xl, self.p["head"]["w"])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _run(fn):
    """fn() with TF32 off and no autograd."""
    old = torch.backends.cuda.matmul.allow_tf32
    old_dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
        torch.backends.cudnn.allow_tf32 = old_dnn


def last_logits(cfg: dict, params: dict, tokens: torch.Tensor,
                quant: str = "none") -> torch.Tensor:
    """(B, S) tokens -> (B, vocab) float32 last-position logits."""
    ref = Plain(cfg, params, quant)
    return _run(lambda: ref.logits(ref.hidden(tokens)[:, -1]))


def all_logits(cfg: dict, params: dict, tokens: torch.Tensor,
               drop: bool = True) -> torch.Tensor:
    """(B, S) tokens -> (B, S, vocab) float32 logits at every position.
    ``drop=False`` gives every expert room for all of a row's tokens: the
    model without the capacity's drops, which a decode step (one token at
    a time) never reaches."""
    ref = Plain(cfg, params, drop=drop)
    return _run(lambda: ref.logits(ref.hidden(tokens)))


def hidden(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> (B, S, D) float32 hidden states after the final
    norm."""
    ref = Plain(cfg, params)
    return _run(lambda: ref.hidden(tokens))


def moe_layer(cfg: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    """One MoE layer on (B, S, D) float32 ``x``, row by row: the held
    experts' part plus the shared expert."""
    ref = Plain(cfg, {})
    return _run(lambda: torch.stack([ref.moe(m, r) for r in x]))


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.to(torch.float32) - want)
                 / torch.linalg.vector_norm(want))


def branch_gaps(cfg: dict, params: dict, tokens: torch.Tensor,
                other=None) -> list[float]:
    """Every residual branch of the model on the same input, in order:
    each layer's norm and mixer, its norm and FFN, then the final norm and
    the head at each row's last position. A branch's input is the
    reference's own stream rounded to bfloat16 (the program's activation
    dtype), handed to both sides; the reference rounds its norm's output
    to bfloat16 too, as the program hands its mixer or FFN, so that both
    sides route a token alike. The stream then goes on with the
    reference's output. ``other(part, kind,
    layer tree, x)`` gives the output under test (part "mixer", "ffn" or
    "head"; kind as ``Plain.layers`` names it; x the (B, S, D) bfloat16
    stream) and runs outside the reference's settings; None compares the
    reference with float8 products (the control). → the relative L2 gap
    ||got - want|| / ||want|| of each branch over all rows and
    positions."""
    ref = Plain(cfg, params)
    ctl = Plain(cfg, params, quant="fp8")

    def under_test(part, kind, lp, x):
        if other is not None:
            return other(part, kind, lp, x.to(torch.bfloat16))
        if part == "head":
            return _run(lambda: ctl.head(x, rounded=True))
        return _run(lambda: getattr(ctl, part)(kind, lp, x, rounded=True))

    x = _run(lambda: ref.embed(tokens))
    gaps = []
    for mixer, ffn, lp in ref.layers():
        for part, kind in (("mixer", mixer), ("ffn", ffn)):
            x = _bf16(x)
            want = _run(lambda: getattr(ref, part)(kind, lp, x,
                                                   rounded=True))
            gaps.append(_gap(under_test(part, kind, lp, x), want))
            x = x + want
    x = _bf16(x[:, -1:])
    want = _run(lambda: ref.head(x, rounded=True))
    gaps.append(_gap(under_test("head", "head", None, x), want))
    return gaps
