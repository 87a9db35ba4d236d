"""Weights and inputs made from ``--seed``, on the run's device, in a few
large draws of a ``torch.Generator`` on that device. Both the program and
the plain reference read these tensors; neither makes its own."""
from __future__ import annotations

import torch

from h100bench.work import bcnn as bcnn_work


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer below
    2**64; the driver's seeds are larger than 32 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)


# ---------------------------------------------------------------------------
# the BCNN: latent float weights and stored batch-norm statistics
# ---------------------------------------------------------------------------

def _bn(g: torch.Generator, o: int, scale: float, device) -> dict:
    """Stored BN statistics at the scale of the layer's pre-activation
    (variance ~ fan-in on the +-1 layers), gamma of both signs, so that
    flipped comparators occur."""
    def u(lo, hi):
        return torch.rand(o, generator=g, device=device) * (hi - lo) + lo
    sign = torch.where(torch.rand(o, generator=g, device=device) < 0.5,
                       -1.0, 1.0)
    return {"bn_mean": torch.randn(o, generator=g, device=device)
            * (0.3 * scale ** 0.5),
            "bn_var": u(0.5, 2.0) * scale,
            "bn_gamma": u(0.5, 1.5) * sign,
            "bn_beta": torch.randn(o, generator=g, device=device) * 0.3}


def bcnn_params(seed: int, device) -> dict:
    """The Table 2 BCNN's latent weights: CONV-1 N(0, 0.1^2), the binary
    layers U(-1, 1); conv weights (O, 3, 3, I), FC weights (O, I)."""
    g = generator(seed, device)
    _, _, ci, co, _ = bcnn_work.CONVS[0]
    conv1 = {"w": torch.randn((co, 3, 3, ci), generator=g, device=device)
             * 0.1, **_bn(g, co, 400.0, device)}
    convs = [{"w": torch.rand((o, 3, 3, i), generator=g, device=device)
              * 2 - 1, **_bn(g, o, 9.0 * i, device)}
             for _, _, i, o, _ in bcnn_work.CONVS[1:]]
    fcs = [{"w": torch.rand((o, i), generator=g, device=device) * 2 - 1,
            **_bn(g, o, float(i), device)} for i, o in bcnn_work.FCS]
    return {"conv1": conv1, "convs": convs, "fcs": fcs}


def images(seed: int, n: int, device) -> torch.Tensor:
    """``n`` distinct (32, 32, 3) float32 images in [0, 1]."""
    g = generator(seed + 1, device)
    return torch.rand((n, 32, 32, 3), generator=g, device=device)


# ---------------------------------------------------------------------------
# DeepSeek-V2: the port's stacked parameter layout
# ---------------------------------------------------------------------------

def _normal(g, shape, dtype, std, device) -> torch.Tensor:
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.mul_(std)


def deepseek_params(c: dict, seed: int, device,
                    dtype=torch.bfloat16) -> dict:
    """The tree the port's ``models/transformer.py`` reads for the moe
    family (keys, shapes and dtypes of its ``init_params``): weights
    N(0, 1/d_in) in ``dtype``, one draw per stacked leaf; the router in
    float32; norm scales of ones; the embedding N(0, 0.02^2)."""
    g = generator(seed, device)
    d, v = c["hidden_size"], c["vocab_size"]
    h, r = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    e, fe = c["n_routed_experts"], c["moe_intermediate_size"]
    fs = c["n_shared_experts"] * fe
    nd = c["first_k_dense_replace"]
    nm = c["num_hidden_layers"] - nd

    def w(*shape):
        return {"w": _normal(g, shape, dtype, shape[-2] ** -0.5, device)}

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=torch.float32,
                                    device=device)}

    def attn_block(n):
        return {"ln1": ones(n, d),
                "attn": {"wq": w(n, d, h * (dn + dr)),
                         "wkv_a": w(n, d, r + dr), "kv_norm": ones(n, r),
                         "wk_b": w(n, r, h * dn), "wv_b": w(n, r, h * dv),
                         "wo": w(n, h * dv, d)},
                "ln2": ones(n, d)}

    def swiglu(n, width):
        return {"wi": w(n, d, width), "wg": w(n, d, width),
                "wo": w(n, width, d)}

    params = {"embed": {"embedding": _normal(g, (v, d), dtype, 0.02, device)},
              "final_norm": ones(d), "head": w(d, v)}
    if nd:
        params["stack0_dense_attn_mla"] = {
            **attn_block(nd), "mlp": swiglu(nd, c["intermediate_size"])}
    if nm:
        params["stack1_moe"] = {
            **attn_block(nm),
            "moe": {"router": {"w": _normal(g, (nm, d, e), torch.float32,
                                            d ** -0.5, device)},
                    "experts": {
                        "wi": _normal(g, (nm, e, d, fe), dtype, d ** -0.5,
                                      device),
                        "wg": _normal(g, (nm, e, d, fe), dtype, d ** -0.5,
                                      device),
                        "wo": _normal(g, (nm, e, fe, d), dtype, fe ** -0.5,
                                      device)},
                    "shared": swiglu(nm, fs)}}
    return params


def token_pool(seed: int, rows: int, seq: int, vocab: int,
               device) -> torch.Tensor:
    """(rows, seq) int64 token ids, uniform over the vocabulary."""
    g = generator(seed + 1, device)
    return torch.randint(0, vocab, (rows, seq), generator=g, device=device)
