"""Long prompts of Kimi Linear answered with their first token:
back-to-back ``models/transformer.py::prefill`` calls of ``batch`` rows,
closed loop, one caller, each ending when its last-position logits are
back on the host; the traffic of ``prefill_stream.py`` (its schedule of
lengths, token pool, window and sample of checked calls), on this
configuration's own weights, reference and work count.

The port's configuration is resolved first, before any weight is drawn:
a program without it fails at once. The weights are the port's stacked
tree for the moe family with KDA layers, on the configuration's expert
share: each MoE layer holds ``num_experts`` (the share) of the published
experts and routes over all of them."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from h100bench import programs, weights
from h100bench.drivers.prefill_stream import _tokens, rel_gap, sample, \
    schedule
from h100bench.reference import kimi_linear_plain as reference
from h100bench.work import kimi_linear as work

# configuration file key -> the port's PortModelConfig field
_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
         "num_attention_heads": "n_heads",
         "num_key_value_heads": "n_kv_heads",
         "intermediate_size": "d_ff", "vocab_size": "vocab_size",
         "kv_lora_rank": "kv_lora_rank",
         "qk_nope_head_dim": "qk_nope_head_dim",
         "qk_rope_head_dim": "qk_rope_head_dim",
         "v_head_dim": "v_head_dim",
         "num_experts_per_token": "top_k",
         "moe_intermediate_size": "moe_d_ff",
         "num_shared_experts": "n_shared_experts",
         "first_k_dense_replace": "first_dense_layers",
         "routed_scaling_factor": "routed_scale"}


@dataclass
class State:
    mcfg: object
    sizes: dict            # the reference's and the work count's sizes
    params: dict
    pool: torch.Tensor
    lengths: list


def port_config(cfg: dict, smoke: bool = False):
    """The port's config of ``cfg["program"]`` with every size taken from
    the configuration file (``smoke``: the port's small preset, holding
    the first half of its experts, for the CPU tests), at the file's
    dtype. Raises where the program has no such architecture."""
    from repro_torch import configs
    base = configs.get_config(cfg["program"], smoke=smoke)
    if smoke:
        return base.with_(dtype=cfg["torch_dtype"],
                          expert_share=(0, base.n_experts // 2))
    lin = cfg["linear_attn_config"]
    first, count = cfg["expert_share"]
    return base.with_(
        **{f: cfg[k] for k, f in _KEYS.items()},
        q_lora_rank=cfg["q_lora_rank"] or 0,
        n_experts=cfg["published"]["num_experts"],
        expert_share=(first, count),
        kda_layers=tuple(lin["kda_layers"]), kda_heads=lin["num_heads"],
        kda_head_dim=lin["head_dim"],
        mla_nope=cfg["mla_use_nope"],
        router=cfg["moe_router_activation_func"],
        dtype=cfg["torch_dtype"], quant="none", remat=False)


def file_sizes(mcfg) -> dict:
    """The sizes of a port config under the configuration file's keys, the
    linear attention's flattened (what the reference and the work count
    read)."""
    out = {k: getattr(mcfg, f) for k, f in _KEYS.items()}
    out.update(num_experts=mcfg.n_experts,
               expert_share=list(mcfg.expert_share
                                 or (0, mcfg.n_experts)),
               kda_layers=list(mcfg.kda_layers),
               kda_num_heads=mcfg.kda_heads,
               kda_head_dim=mcfg.kda_head_dim,
               kda_gate_rank=mcfg.kda_head_dim)
    return out


def kinds(c: dict) -> dict:
    """Layers of each stacked kind, under the port's stack keys."""
    n = {"dense_attn_mla": 0, "moe": 0, "dense_kda": 0, "moe_kda": 0}
    for i in range(1, c["num_hidden_layers"] + 1):
        dense = i <= c["first_k_dense_replace"]
        if i in c["kda_layers"]:
            n["dense_kda" if dense else "moe_kda"] += 1
        else:
            n["dense_attn_mla" if dense else "moe"] += 1
    return {f"stack{j}_{kind}": m for j, (kind, m) in enumerate(n.items())
            if m}


def kimi_params(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree the port's ``models/transformer.py`` reads for the moe
    family with KDA layers (keys, shapes and dtypes of its
    ``init_params``, the held experts only): weights N(0, 1/d_in) in
    ``dtype``, one draw per stacked leaf; the conv N(0, 1/4); the router
    and its selection bias N(0, 0.01²) in float32; A_log = log U(1, 16)
    per head; dt_bias the inverse softplus of a rate log-uniform in
    [1e-3, 0.1] per channel; norm scales of ones; the embedding
    N(0, 0.02²)."""
    g = weights.generator(seed, device)
    d, v = c["hidden_size"], c["vocab_size"]
    h, r = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    e, eh = c["num_experts"], c["expert_share"][1]
    fe = c["moe_intermediate_size"]
    kh, kd, kr = c["kda_num_heads"], c["kda_head_dim"], c["kda_gate_rank"]
    kw = kh * kd
    f32 = torch.float32

    def normal(shape, std, dt=dtype):
        return weights._normal(g, shape, dt, std, device)

    def w(*shape):
        return {"w": normal(shape, shape[-2] ** -0.5)}

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=f32, device=device)}

    def uniform(shape):
        return torch.rand(shape, generator=g, device=device)

    def mla(n):
        return {"wq": w(n, d, h * (dn + dr)), "wkv_a": w(n, d, r + dr),
                "kv_norm": ones(n, r), "wk_b": w(n, r, h * dn),
                "wv_b": w(n, r, h * dv), "wo": w(n, h * dv, d)}

    def kda(n):
        dt = torch.exp(uniform((n, kw)) * (np.log(0.1) - np.log(1e-3))
                       + np.log(1e-3))
        return {"wqkv": w(n, d, 3 * kw),
                "conv_w": normal((n, 4, 3 * kw), 0.5),
                "f_a": w(n, d, kr), "f_b": w(n, kr, kw),
                "a_log": torch.log(1.0 + 15.0 * uniform((n, kh))),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                "b": w(n, d, kh), "g_a": w(n, d, kr), "g_b": w(n, kr, kw),
                "o_norm": ones(n, kd), "wo": w(n, kw, d)}

    def swiglu(n, width):
        return {"wi": w(n, d, width), "wg": w(n, d, width),
                "wo": w(n, width, d)}

    def moe(n):
        return {"router": {"w": normal((n, d, e), d ** -0.5, f32),
                           "bias": normal((n, e), 0.01, f32)},
                "experts": {"wi": normal((n, eh, d, fe), d ** -0.5),
                            "wg": normal((n, eh, d, fe), d ** -0.5),
                            "wo": normal((n, eh, fe, d), fe ** -0.5)},
                "shared": swiglu(n, c["num_shared_experts"] * fe)}

    params = {"embed": {"embedding": normal((v, d), 0.02)},
              "final_norm": ones(d), "head": w(d, v)}
    for key, n in kinds(c).items():
        kind = key.split("_", 1)[1]
        block = {"ln1": ones(n, d), "ln2": ones(n, d)}
        block.update({"kda": kda(n)} if kind.endswith("kda")
                     else {"attn": mla(n)})
        block.update({"moe": moe(n)} if kind.startswith("moe")
                     else {"mlp": swiglu(n, c["intermediate_size"])})
        params[key] = block
    return params


def setup(run) -> State:
    p = run.params
    mcfg = port_config(run.config, smoke=run.smoke)
    sizes = file_sizes(mcfg)
    params = kimi_params(sizes, run.seed, run.device,
                         dtype=getattr(torch, mcfg.dtype))
    lengths = p["lengths"]
    pool = weights.token_pool(run.seed, p["pool_rows"], max(lengths),
                              sizes["vocab_size"], run.device)
    st = State(mcfg, sizes, params, pool, lengths)
    for s in sorted(set(lengths)):           # this cell's shapes, once each
        programs.lm_prefill(mcfg, params, pool[:p["batch"], :s]).cpu()
    return st


def drive(run, st: State) -> dict:
    p = run.params
    b = p["batch"]
    sched = schedule(st.lengths, p["max_calls"])
    tracer = run.tracer
    clock = time.perf_counter
    calls = []        # (k, length, host seconds, in the slice)
    logits = {}
    attempted = 0
    t0 = clock()
    for k, s in enumerate(sched):
        tracer.tick(clock() - t0)
        attempted += 1
        toks = _tokens(st, b, k, s)
        ts = clock()
        out = programs.lm_prefill(st.mcfg, st.params, toks)
        lg = out[:, -1, :].float().cpu()
        te = clock()
        logits[k] = lg
        calls.append((k, s, te - ts, tracer.active))
        if te - t0 >= run.seconds:
            window = te - t0
            break
    else:
        raise RuntimeError(f"{run.cell}: max_calls {p['max_calls']} ran out "
                           f"before the window closed")
    tracer.stop()
    tokens = sum(b * c[1] for c in calls)
    c_in = [c for c in calls if c[3]]
    c_out = [c for c in calls if not c[3]]
    return {
        "e2e": {"prefill_tokens_per_s": tokens / window},
        "attempted": attempted, "failed": 0, "logits": logits,
        "calls": calls, "batch": b,
        "tokens_in": sum(b * c[1] for c in c_in),
        "lengths_in": [c[1] for c in c_in],
        "flops_out": sum(work.prefill_flops(st.sizes, b, c[1])
                         for c in c_out),
        "time_out": window - run.tracer.taken_s,
        "sizes": st.sizes,
    }


def program_branch(st: State):
    """The program's residual branches, as ``reference.branch_gaps`` calls
    them: the norm and the mixer (``models/kda.py::kda_forward`` from a
    zero state, or ``models/mla.py::mla_forward``), the norm and the FFN
    (``models/moe.py::moe_apply`` or the dense SwiGLU), or the final norm
    and the head, each on the (B, S, D) stream it is handed."""
    from repro_torch.models import kda, layers, mla, moe
    cfg, norm = st.mcfg, st.mcfg.norm_type

    def branch(part, kind, lp, x):
        with torch.no_grad():
            if part == "head":
                h = layers.apply_norm(st.params["final_norm"], x, norm)
                return layers.logits_head(st.params["head"], h)
            h = layers.apply_norm(lp["ln1" if part == "mixer" else "ln2"],
                                  x, norm)
            if kind == "kda":
                return kda.kda_forward(lp["kda"], cfg, h, kda.init_state(
                    cfg, x.shape[0], x.device))[0]
            if kind == "mla":
                pos = torch.arange(x.shape[1], device=x.device)[None, :]
                return mla.mla_forward(lp["attn"], cfg, h, pos)
            if kind == "moe":
                return moe.moe_apply(lp["moe"], cfg, h)[0]
            return layers.mlp_apply(lp["mlp"], h, cfg.mlp_type, cfg.quant)
    return branch


def check(run, st: State, record: dict, control: bool = False) -> dict:
    """Two numbers against the plain float32 reference (the KDA rule
    token by token):

    * ``logit_rel_err_median``: the sampled calls' last-position logits,
      the relative L2 gap ||got - want|| / ||want|| of each row, and its
      median over the rows. End to end, so bf16's flips of the sigmoid
      router's near-ties weigh in.
    * ``branch_rel_err_max``: every residual branch (each layer's norm and
      mixer, its norm and FFN, the final norm and the head) of the
      program on the same bfloat16 input as the reference's, the first
      ``branch_tokens`` positions of the longest sampled call's rows
      (``reference.branch_gaps``): the largest relative gap. Both sides
      route alike, so rounding alone sets it.

    The control: the reference computed with float8 products in the
    program's place."""
    b = record["batch"]
    picked = sample(run, record)
    record["logits"] = {c[0]: record["logits"][c[0]] for c in picked}
    gc.collect()
    if st.pool.is_cuda:
        torch.cuda.empty_cache()
    gaps = []
    for k, s, _, _ in picked:
        toks = _tokens(st, b, k, s)
        want = reference.last_logits(st.sizes, st.params, toks)
        got = (reference.last_logits(st.sizes, st.params, toks,
                                     quant="fp8")
               if control else record["logits"][k].to(want.device))
        gaps.extend(rel_gap(got, want).tolist())
    k, s = picked[0][:2]
    toks = _tokens(st, b, k, min(s, run.params["branch_tokens"]))
    branches = reference.branch_gaps(
        st.sizes, st.params, toks, None if control else program_branch(st))
    return {"logit_rel_err_median": float(np.median(gaps)),
            "branch_rel_err_max": max(branches)}
