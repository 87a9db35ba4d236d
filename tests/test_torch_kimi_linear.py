"""Kimi Linear on the port (``configs/kimi_linear_48b_a3b.py``,
``models/kda.py``, the moe family's KDA layers in
``models/transformer.py``, MLA without RoPE, the sigmoid router and the
expert share of ``models/moe.py``) against the benchmark's plain float32
reference (``h100bench/reference/kimi_linear_plain.py``, which imports
nothing of the port), at ``SMOKE_CONFIG`` size on seeded random weights:
the pattern's two mixers (KDA at layers 1-3, MLA at 4), the dense first
layer, 16 experts held as two shares of 8."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from h100bench.drivers import kimi_prefill_stream as driver  # noqa: E402
from h100bench.reference import kimi_linear_plain as ref  # noqa: E402
from repro_torch import configs, trace  # noqa: E402
from repro_torch.models import kda, layers, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCH = "kimi-linear-48b-a3b"


def smoke(dtype="float32", share=(0, 8)):
    return configs.get_config(ARCH, smoke=True).with_(dtype=dtype,
                                                      expert_share=share)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    cfg = smoke()
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    return cfg, params, driver.file_sizes(cfg)


def tokens(cfg, b, s, seed=4):
    return torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def rel(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


# ----------------------------------------------------------------- config

def test_config_is_the_published_model_outside_the_reference_table():
    cfg = configs.get_config(ARCH)
    assert ARCH not in configs.ARCH_NAMES
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff) == \
        (27, 2304, 163840, 9216)
    assert (cfg.kda_heads, cfg.kda_head_dim, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == \
        (32, 128, 32, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.n_shared_experts,
            cfg.routed_scale, cfg.router, cfg.mla_nope) == \
        (256, 8, 1024, 1, 2.446, "sigmoid", True)
    kinds = tf._layer_kinds(cfg)
    mla_at = [i + 1 for i, k in enumerate(kinds) if "kda" not in k]
    assert mla_at == [4, 8, 12, 16, 20, 24, 27]
    assert kinds[0] == "dense_kda" and kinds.count("moe_kda") == 19
    sm = configs.get_config(ARCH, smoke=True)
    assert set(tf._layer_kinds(sm)) == {"dense_kda", "moe_kda", "moe"}
    assert sm.n_experts >= 16 and sm.n_experts // 2 >= 8


def test_reference_configs_keep_their_fields():
    """The new settings are class attributes of ``ModelConfig``, fields only
    of ``PortModelConfig``: a config of the reference's table reads today's
    behaviour and keeps the reference's keys."""
    ds = configs.get_config("deepseek-v2-lite-16b")
    names = {f.name for f in dataclasses.fields(ds)}
    assert not names & {"kda_layers", "router", "expert_share", "mla_nope"}
    assert (ds.kda_layers, ds.router, ds.expert_share, ds.mla_nope,
            ds.routed_scale) == ((), "softmax", (), False, 1.0)
    assert moe.held(ds) == (0, 64)


# ------------------------------------------------------------ the KDA rule

def chunked(q, k, v, g, beta, s0):
    """``kda._chunked`` on (B, S, H, d) inputs, its output laid back."""
    o, s_fin = kda._chunked([kda.to_chunks(t) for t in
                             (q, k, v, g, beta[..., None])], s0)
    return kda.from_chunks(o, q.shape[1]), s_fin


@pytest.mark.parametrize("s,decay", [(37, 0.3), (100, 1.0), (130, 40.0),
                                     (64, 0.0), (1, 1.0)])
def test_chunked_rule_is_the_token_recurrence(s, decay):
    """The chunked algebra against the rule one token at a time, at lengths
    that are not multiples of the chunk (and one that is), from a nonzero
    state. In float64 the two orders of arithmetic agree to 1e-12; a
    decay of 40 a token is far past what factoring e^{G_t} e^{-G_j} over a
    chunk could hold (e^{2560}), and stays exact."""
    g = torch.Generator().manual_seed(s)
    b, h, d = 2, 3, 8
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=f64)
    q = kda._l2norm_(randn(b, s, h, d)) * d ** -0.5
    k = kda._l2norm_(randn(b, s, h, d))
    v = randn(b, s, h, d)
    gg = -torch.rand((b, s, h, d), generator=g, dtype=f64) * decay
    beta = torch.rand((b, s, h), generator=g, dtype=f64)
    s0 = randn(b, h, d, d)
    o1, s1 = kda._scan(q, k, v, gg, beta, s0)
    o2, s2 = chunked(q, k, v, gg, beta, s0)
    torch.testing.assert_close(o2, o1, rtol=0, atol=1e-12)
    torch.testing.assert_close(s2, s1, rtol=0, atol=1e-12)


def test_chunked_rule_float32_strong_decay_is_finite():
    """float32, decays that underflow whole chunks: no inf or nan, and the
    token recurrence's values within float32 rounding (1e-5 of outputs of
    order 1)."""
    g = torch.Generator().manual_seed(9)
    b, s, h, d = 1, 200, 2, 16
    q = kda._l2norm_(torch.randn((b, s, h, d), generator=g)) * d ** -0.5
    k = kda._l2norm_(torch.randn((b, s, h, d), generator=g))
    v = torch.randn((b, s, h, d), generator=g)
    gg = -torch.rand((b, s, h, d), generator=g) * 60.0
    beta = torch.rand((b, s, h), generator=g)
    s0 = torch.zeros(b, h, d, d)
    o1, _ = kda._scan(q, k, v, gg, beta, s0)
    o2, _ = chunked(q, k, v, gg, beta, s0)
    assert torch.isfinite(o2).all()
    torch.testing.assert_close(o2, o1, rtol=0, atol=1e-5)


# ------------------------------------------------- the port vs the reference

def test_prefill_matches_the_reference(model):
    """Last-position logits and the full sequence's hidden states, the port
    in float32 against the reference in float32 (TF32 off). The two differ
    only in the order of float32 sums (the chunked rule against the token
    recurrence, blocked against plain attention, batched experts): 1e-4
    relative holds them, a hundred times float32 rounding at these sizes
    and far under any bf16 effect (~1e-2)."""
    cfg, params, sizes = model
    toks = tokens(cfg, 2, 45)
    with torch.no_grad():
        got = tf.prefill(cfg, params, toks)[:, 0]
        hid, _ = tf.forward_hidden(cfg, params, tf.Batch(toks, toks))
    assert rel(got, ref.last_logits(sizes, params, toks)) < 1e-4
    assert rel(hid.reshape(-1, cfg.d_model),
               ref.hidden(sizes, params, toks).reshape(-1, cfg.d_model)) \
        < 1e-4


def test_bf16_prefill_against_the_reference():
    """The configuration's dtype: the port in bf16 against the float32
    reference on the same bf16 weights, the median over 8 rows of the
    relative gap of the last-position logits (the cell's check). At this
    width bf16 flips near-tied routing choices, which move single rows by
    up to ~0.4 (the reference computed in bf16 does the same); the median
    reads 0.16 here, under 0.25, while the fp8 control's reads over twice
    the program's (0.46)."""
    cfg = smoke("bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    sizes = driver.file_sizes(cfg)
    toks = tokens(cfg, 8, 40, seed=6)
    with torch.no_grad():
        got = tf.prefill(cfg, params, toks)[:, 0].float()
    want = ref.last_logits(sizes, params, toks)

    def median_gap(x):
        return float(torch.median(torch.linalg.vector_norm(x - want, dim=-1)
                                  / torch.linalg.vector_norm(want, dim=-1)))
    gap = median_gap(got)
    assert gap < 0.25
    assert median_gap(ref.last_logits(sizes, params, toks, quant="fp8")) \
        > 2 * gap


def test_decode_through_the_cache_matches_the_full_forward(model):
    """Tokens fed one at a time through ``decode_step`` from an empty serve
    state (KDA conv tails and states beside the MLA layer's latents) give
    the reference's full-forward logits at every position. A decode step
    routes one token, which no capacity drops, so the reference runs
    without the capacity's drops. 1e-4 relative, as the prefill."""
    cfg, params, sizes = model
    s = 20
    toks = tokens(cfg, 2, s, seed=7)
    st = tf.init_serve_state(cfg, 2, s)
    assert set(st.caches) == {"kda", "mla"}
    assert st.caches["kda"].s.shape == (3, 2, cfg.kda_heads,
                                        cfg.kda_head_dim, cfg.kda_head_dim)
    assert st.caches["mla"].c_kv.shape == (1, 2, s, cfg.kv_lora_rank)
    out = []
    with torch.no_grad():
        for t in range(s):
            lg, st = tf.decode_step(cfg, params, st, toks[:, t:t + 1])
            out.append(lg[:, 0])
    got = torch.stack(out, 1)
    want = ref.all_logits(sizes, params, toks, drop=False)
    assert rel(got.reshape(-1, cfg.vocab_size),
               want.reshape(-1, cfg.vocab_size)) < 1e-4


# ------------------------------------------------------- the expert share

def test_two_shares_add_up_to_the_uncut_layer():
    """Experts 0-7 and 8-15 of a 16-expert layer, each routed over all 16
    with the whole layer's capacity, add up to the uncut reference layer
    with the shared expert counted once; each share equals the reference
    given the same share. float32, 1e-5 relative (sums in another order)."""
    full = smoke(share=())
    p = moe.moe_init(torch.Generator().manual_seed(11), full, torch.float32)
    x = torch.randn((2, 30, full.d_model),
                    generator=torch.Generator().manual_seed(12))

    def share(first, count):
        cfg = full.with_(expert_share=(first, count))
        ex = {k: w[first:first + count] for k, w in p["experts"].items()}
        return cfg, {**p, "experts": ex}
    parts = []
    for first in (0, 8):
        cfg, ps = share(first, 8)
        with torch.no_grad():
            y, aux = moe.moe_apply(ps, cfg, x)
        want = ref.moe_layer(driver.file_sizes(cfg), ps, x)
        assert rel(y, want) < 1e-5
        assert float(aux) == 0.0
        parts.append(y)
    shared = layers.mlp_apply(p["shared"], x)
    uncut = ref.moe_layer(driver.file_sizes(full), p, x)
    assert rel(parts[0] + parts[1] - shared, uncut) < 1e-5
    with torch.no_grad():
        whole, _ = moe.moe_apply(p, full, x)
    assert rel(whole, uncut) < 1e-5


def test_sigmoid_router_picks_by_bias_and_weights_by_score():
    """The selection bias moves which experts are chosen but not their
    gates: the chosen scores, renormalised, times routed_scale."""
    cfg = smoke(share=())
    p = moe.moe_init(torch.Generator().manual_seed(13), cfg, torch.float32)
    x = torch.randn((1, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(14))
    big = torch.zeros(cfg.n_experts)
    big[[3, 5, 7, 9]] = 10.0
    gates, idx = moe.route_sigmoid({"router": {**p["router"],
                                               "bias": big}}, cfg, x)
    assert sorted(idx[0, 0].tolist()) == [3, 5, 7, 9]
    s = torch.sigmoid(x @ p["router"]["w"])
    want = torch.gather(s, -1, idx)
    want = want / want.sum(-1, keepdim=True) * cfg.routed_scale
    torch.testing.assert_close(gates, want)
    torch.testing.assert_close(gates.sum(-1),
                               torch.full((1, 5), cfg.routed_scale))


# ------------------------------------------------------------------ trace

def test_kda_spans_and_held_pairs_are_recorded(model):
    """Under ``trace.enable()`` each KDA layer records ``kda.proj``,
    ``kda.scan`` and ``kda.out`` in order, and each MoE layer counts its
    pairs, the held ones (about half on a share of 8 of 16) and the held
    ones dropped; the logits equal an untraced run's."""
    cfg, params, _ = model
    toks = tokens(cfg, 2, 40, seed=8)
    trace.disable()
    trace.reset()
    with torch.no_grad():
        off = tf.prefill(cfg, params, toks)
        trace.enable()
        try:
            on = tf.prefill(cfg, params, toks)
        finally:
            trace.disable()
    spans, counters = trace.drain()
    names = [s["name"] for s in spans if s["name"].startswith("kda.")]
    assert names == ["kda.proj", "kda.scan", "kda.out"] * 3
    n_moe = 3
    pairs = n_moe * 2 * 40 * cfg.top_k
    assert counters["moe.pairs"] == pairs
    assert 0.3 * pairs < counters["moe.pairs_held"] < 0.7 * pairs
    assert 0 <= counters["moe.pairs_dropped"] <= counters["moe.pairs_held"]
    assert torch.equal(on, off)


def test_tree_layout_stacks_each_kind(model):
    cfg, params, _ = model
    assert {k for k in params if k.startswith("stack")} == \
        {"stack1_moe", "stack2_dense_kda", "stack3_moe_kda"}
    assert params["stack3_moe_kda"]["moe"]["experts"]["wi"].shape[:2] == \
        (2, 8)
    assert params["stack3_moe_kda"]["moe"]["router"]["w"].shape[-1] == 16
    assert np.array_equal(
        [i + 1 for i, k in enumerate(tf._layer_kinds(cfg)) if "kda" in k],
        cfg.kda_layers)
