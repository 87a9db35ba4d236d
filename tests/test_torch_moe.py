"""The port's DeepSeek-V2 MoE FFN (``repro_torch/models/moe.py``) on the
CPU against the live JAX reference (``repro/models/moe.py``), on the
reference's ``moe_init`` weights carried across as numpy arrays and the
same seeded numpy inputs, at both deepseek smoke configs' widths.

Tolerances: float32 rtol = atol = 1e-5 (y and aux; the k choices of a
token are summed in another order than the reference's scatter-add, a
float32 ulp); bfloat16 y at the LM zoo's ``BF16`` (rtol 2e-2, atol
6.25e-2: the reference rounds inside silu and the expert products where
PyTorch's fused ops do not). The expert products are plain batched
matmuls in both packages (no kernel), so the drops and the routing are
equal on the same inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
# the reference compiled once per (cfg, shape): its eager op-by-op run
# compiles every primitive apart and costs seconds a call
jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=1)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def expert_layer(arch: str, dtype: str = "float32", seed: int = 0):
    """(port cfg, reference cfg, reference MoE params, port params) of one
    MoE layer at the arch's smoke widths."""
    jcfg = jconfigs.get_config(arch, smoke=True).with_(dtype=dtype)
    cfg = configs.get_config(arch, smoke=True).with_(dtype=dtype)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.jit(jmoe.moe_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jcfg, dt)
    return cfg, jcfg, jp, _to_port(cfg, jp)


def _to_port(cfg, tree):
    return tf.params_from_numpy(cfg, jax.tree.map(np.asarray, tree))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _x(cfg, shape, seed=1, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (64, 6), (160, 6)])
def test_capacity_matches_reference(e, k):
    for tokens in (1, 7, 8, 9, 13, 100, 256, 1024, 4096):
        for factor in (1.0, moe.CAPACITY_FACTOR, 2.0):
            assert (moe.capacity(tokens, e, k, factor)
                    == jmoe.capacity(tokens, e, k, factor))
    assert moe.CAPACITY_FACTOR == jmoe.CAPACITY_FACTOR
    # at most 8 tokens never drop: every expert's capacity holds them all
    assert all(moe.capacity(s, e, k) >= s for s in range(1, 9))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_reference_tree(arch):
    cfg, jcfg, _, _ = expert_layer(arch)
    cfg, jcfg = (c.with_(dtype="bfloat16") for c in (cfg, jcfg))
    jp = jax.eval_shape(lambda: jmoe.moe_init(jax.random.PRNGKey(0), jcfg,
                                              jnp.bfloat16))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    spec = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        p) == spec
    assert p["router"]["w"].dtype == torch.float32      # router stays fp32
    wi = p["experts"]["wi"].to(torch.float32)
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("quant", ["none", "binary_weights", "binary"])
def test_stacked_dense_matches_reference_vmap(quant):
    """``layers.dense`` on an (E, d_in, d_out) stack: α per expert over its
    own d_in, as the reference's ``vmap`` of ``dense`` over E."""
    cfg, _, jp, p = expert_layer("deepseek-v2-236b")
    x = np.random.default_rng(2).standard_normal(
        (cfg.n_experts, 5, cfg.d_model)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda w, h: jlayers.dense({"w": w}, h, quant)))(
        jp["experts"]["wi"], jnp.asarray(x))
    got = layers.dense({"w": p["experts"]["wi"]}, torch.from_numpy(x), quant)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("quant", ["none", "binary_weights", "binary"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, quant):
    cfg, jcfg, jp, p = expert_layer(arch)
    cfg, jcfg = cfg.with_(quant=quant), jcfg.with_(quant=quant)
    jx, x = _x(cfg, (2, 16))
    want_y, want_aux = jmoe_apply(jp, jcfg, jx)
    y, aux = moe.moe_apply(p, cfg, x)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    cfg, jcfg, jp, p = expert_layer(arch, "bfloat16")
    jx, x = _x(cfg, (2, 16), dtype="bfloat16")
    want_y, want_aux = jmoe_apply(jp, jcfg, jx)
    y, aux = moe.moe_apply(p, cfg, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), **BF16)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


def _crowded(arch):
    """The arch's MoE layer with a router that sends nearly every token to
    expert 0, and inputs that share one direction u: rows over capacity."""
    cfg, jcfg, jp, _ = expert_layer(arch)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = (u + 0.3 * rng.standard_normal((2, 32, cfg.d_model))).astype(
        np.float32)
    w = np.array(jp["router"]["w"])
    w[:, 0] = 4 * u / np.linalg.norm(u)
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    return cfg, jcfg, jp, x


@pytest.mark.parametrize("arch", ARCHS)
def test_over_capacity_drops_match_reference(arch):
    """Rows over capacity drop the same tokens and give the same output.
    A token's expert-0 pair was dropped (or never made) where zeroing
    expert 0's weights leaves its output unchanged, in each package."""
    cfg, jcfg, jp, x = _crowded(arch)
    p = _to_port(cfg, jp)
    cap = moe.capacity(32, cfg.n_experts, cfg.top_k)
    _, _, idx = moe.route(p, cfg, torch.from_numpy(x))
    to_0 = (idx == 0).any(-1)
    assert int(to_0.sum(-1).min()) > cap        # both rows over capacity
    _, _, _, ok, _ = moe.dispatch(idx, cap)
    counts = torch.stack([torch.bincount(r.reshape(-1),
                                         minlength=cfg.n_experts)
                          for r in idx])
    assert int((~ok).sum()) == int((counts - cap).clamp(min=0).sum())

    def zero_expert0(tree, zeros):
        ex = {k: zeros(v) for k, v in tree["experts"].items()}
        return {**tree, "experts": ex}

    def jzero(a):
        return a.at[0].set(0)

    def tzero(t):
        t = t.clone()
        t[0] = 0
        return t
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = _np(jmoe_apply(jp, jcfg, jx)[0])
    want_0 = _np(jmoe_apply(zero_expert0(jp, jzero), jcfg, jx)[0])
    got = _np(moe.moe_apply(p, cfg, tx)[0])
    got_0 = _np(moe.moe_apply(zero_expert0(p, tzero), cfg, tx)[0])
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got_0, want_0, **F32)
    kept_ref = np.abs(want - want_0).max(-1) > 0
    kept = np.abs(got - got_0).max(-1) > 0
    np.testing.assert_array_equal(kept, kept_ref)
    # the first cap tokens routed to expert 0 in each row are the kept ones
    for r in range(2):
        toks = np.flatnonzero(to_0[r].numpy())
        np.testing.assert_array_equal(np.flatnonzero(kept[r]), toks[:cap])


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_experts_on_and_off(arch, shared):
    cfg, jcfg, jp, p = expert_layer(arch)
    if not shared:
        cfg, jcfg = (c.with_(n_shared_experts=0) for c in (cfg, jcfg))
        jp = {k: v for k, v in jp.items() if k != "shared"}
        p = {k: v for k, v in p.items() if k != "shared"}
        assert "shared" not in moe.moe_init(torch.Generator().manual_seed(0),
                                            cfg, torch.float32)
    jx, x = _x(cfg, (2, 16), seed=4)
    want_y, want_aux = jmoe_apply(jp, jcfg, jx)
    y, aux = moe.moe_apply(p, cfg, x)
    np.testing.assert_allclose(_np(y), _np(want_y), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


def test_decode_token_routes_through_every_expert_buffer():
    """At S = 1 the capacity buffer holds 8 slots an expert and nothing is
    dropped; the routed output equals the dense sum over the token's k
    experts."""
    cfg, _, _, p = expert_layer("deepseek-v2-lite-16b")
    _, x = _x(cfg, (3, 1), seed=5)
    cfg0 = cfg.with_(n_shared_experts=0)
    p0 = {k: v for k, v in p.items() if k != "shared"}
    y, _ = moe.moe_apply(p0, cfg0, x)
    _, gates, idx = moe.route(p0, cfg0, x)
    assert bool(moe.dispatch(idx, moe.capacity(1, cfg.n_experts,
                                               cfg.top_k))[3].all())
    w = p0["experts"]
    want = torch.zeros_like(y)
    for b in range(3):
        for j in range(cfg.top_k):
            e = int(idx[b, 0, j])
            h = x[b, 0]
            o = (torch.nn.functional.silu(h @ w["wg"][e]) * (h @ w["wi"][e])
                 ) @ w["wo"][e]
            want[b, 0] += gates[b, 0, j] * o
    torch.testing.assert_close(y, want, **F32)
