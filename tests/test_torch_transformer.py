"""The port's dense LM zoo on the CPU against the live JAX reference
(``repro/models/{layers,attention,transformer}.py``,
``repro/serve/engine.py``), for every dense arch's ``SMOKE_CONFIG``.

Both sides run on the same parameters: the reference's ``init_params``
tree, mapped to numpy and carried into the port by
``models/transformer.py::params_from_numpy``. Inputs are numpy arrays from
fixed seeds. On the CPU the port's attention is K7's plain version; the
reference's is its blockwise scan (its Pallas kernel runs only on a TPU).
Never against fixed-seed goldens.

Tolerances, each with its reason:

* float32: rtol = atol = 1e-5 for everything that sums (matmuls,
  attention, the whole forward: 2.4e-6 measured); norms and RoPE, which
  do the same float32 elementwise math, 1e-6.
* bfloat16 logits: rtol = 2e-2, atol = 6.25e-2 (four bf16 ulps at the
  logits' scale of 2-4). The reference rounds inside silu and the score
  pipeline where PyTorch's fused ops do not, and every layer's output is
  rounded to bf16, so hidden states differ by a few ulps (0.053
  measured). Argmax must be equal wherever the reference's top-1 leads
  its runner-up by more than 2·atol; inside that margin (ties one ulp
  apart occur) either may win.
* Greedy and served tokens (float32): equal.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.serve import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServingEngine, TransformerServeModel

ARCHS = configs.ARCH_NAMES
# the tests that read the dense tree (stack0_dense_attn, GQA attention,
# K/V caches) run on the dense arches; tests/test_torch_deepseek.py,
# test_torch_mla.py and test_torch_moe.py hold the moe family
DENSE_ARCHS = tuple(a for a in ARCHS
                    if configs.get_config(a).family == "dense")
F32 = dict(rtol=1e-5, atol=1e-5)
ELEM = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=6.25e-2)


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str = "float32", seed: int = 0):
    """(port cfg, reference cfg, reference params, port params)."""
    jcfg = jconfigs.get_config(arch, smoke=True).with_(dtype=dtype)
    cfg = configs.get_config(arch, smoke=True).with_(dtype=dtype)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        ours = configs.get_config(arch, smoke=smoke)
        theirs = jconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    ours = importlib.import_module(configs.ARCH_MODULES[arch])
    assert ([dataclasses.asdict(s) for s in ours.SHAPES]
            == [dataclasses.asdict(s) for s in jconfigs.get_shapes(arch)])
    assert ours.SKIPPED_SHAPES == jconfigs.get_skipped_shapes(arch)
    assert configs.get_config(arch, quant="binary").quant == "binary"


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_every_reference_arch_resolves(name):
    assert configs.get_config(name).name == jconfigs.get_config(name).name
    assert ([dataclasses.asdict(s) for s in configs.get_shapes(name)]
            == [dataclasses.asdict(s) for s in jconfigs.get_shapes(name)])
    assert (configs.get_skipped_shapes(name)
            == jconfigs.get_skipped_shapes(name))


def test_registry_covers_the_reference_table():
    assert set(configs.ARCH_NAMES) == set(jconfigs.ARCH_NAMES)
    assert set(configs.BINARY_LM_MODULES) == set(jconfigs.BINARY_LM_NAMES)
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("whisper-large")


@pytest.mark.parametrize("family", ["speech"])
def test_unknown_families_raise(family):
    """An unknown family raises ValueError(family), as the reference's
    ``_layer_plan`` does."""
    cfg = configs.get_config("qwen3-8b", smoke=True).with_(family=family)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match=family):
        tf.init_params(cfg, g)
    with pytest.raises(ValueError, match=family):
        tf.init_serve_state(cfg, 1, 8)
    params = models("qwen3-8b")[3]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match=family):
        tf.prefill(cfg, params, toks)
    with pytest.raises(ValueError):
        jt.init_params(cfg, jax.random.PRNGKey(0))


def test_sliding_window_raises():
    """A window set on a dense config raises nothing: gqa_forward takes
    the blockwise plain attention (no K7 launch) and gqa_decode_step masks
    the keys out of the window, both as the reference does."""
    cfg, jcfg, jp, params = models("qwen3-8b")
    cfg, jcfg = cfg.with_(window=3), jcfg.with_(window=3)
    p = tf.tree_map(lambda a: a[0], params["stack0_dense_attn"])["attn"]
    jpa = jax.tree.map(lambda a: a[0], jp["stack0_dense_attn"])["attn"]
    x = np.random.default_rng(4).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32)
    kfa.flash_attention.launches = 0
    got = attention.gqa_forward(p, cfg, torch.from_numpy(x), torch.arange(6))
    assert kfa.flash_attention.launches == 0
    want = jattn.gqa_forward(jpa, jcfg, jnp.asarray(x), jnp.arange(6))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    cache = attention.init_cache(cfg, 1, 8, torch.float32)
    jcache = jattn.init_cache(jcfg, 1, 8, jnp.float32)
    for i in range(6):
        got, cache = attention.gqa_decode_step(
            p, cfg, torch.from_numpy(x[:, i:i + 1]), cache)
        want, jcache = jattn.gqa_decode_step(jpa, jcfg, jnp.asarray(
            x[:, i:i + 1]), jcache)
        np.testing.assert_allclose(_np(got), _np(want), **F32)


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_unchanged(arch, dtype):
    cfg, _, jp, p = models(arch, dtype)
    jl = jax.tree.leaves(jp)
    pl = tf.tree_leaves(p)
    assert len(jl) == len(pl)
    back = tf.numpy_params(p)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for k in path:
            node = node[k.key]
        assert node.shape == a.shape
        np.testing.assert_array_equal(node, np.asarray(a, np.float32))
    want = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for a, t in zip(jl, pl):
        assert t.dtype == (want[str(a.dtype)] if str(a.dtype) in want
                           else torch.int32)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_matches_reference_tree(arch):
    cfg, jcfg, jp, _ = models(arch, "bfloat16")
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    ref_spec = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    ours = tf.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert ours == ref_spec
    n_norm = cfg.n_layers * (2 * cfg.d_model + 2 * cfg.head_dim
                             * cfg.qk_norm) + cfg.d_model
    assert sum(t.numel() for t in tf.tree_leaves(p)) == (
        jcfg.param_count() + n_norm)
    # the reference's distributions: N(0, 1/d_in) weights, N(0, 0.02²)
    # embeddings, unit norm scales
    wq = p["stack0_dense_attn"]["attn"]["wq"]["w"].to(torch.float32)
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    emb = p["embed"]["embedding"].to(torch.float32)
    assert abs(float(emb.std()) - 0.02) < 0.002
    assert bool((p["final_norm"]["scale"] == 1).all())


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_norm_matches_reference(arch, norm_type):
    cfg = configs.get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    p = {"scale": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              norm_type)
    got = layers.apply_norm(tf.tree_map(torch.from_numpy, p),
                            torch.from_numpy(x), norm_type)
    np.testing.assert_allclose(_np(got), _np(want), **ELEM)
    init = layers.norm_init(cfg.d_model, norm_type)
    assert set(init) == set(jlayers.norm_init(cfg.d_model, norm_type))


@pytest.mark.parametrize("positions", ["S", "BS"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rope_matches_reference(arch, positions):
    cfg = configs.get_config(arch, smoke=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.n_heads, cfg.head_dim)).astype(
        np.float32)
    pos = (np.arange(7) if positions == "S"
           else rng.integers(0, 500, (2, 7)))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              cfg.rope_theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            cfg.rope_theta)
    np.testing.assert_allclose(_np(got), _np(want), **ELEM)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_mlp_matches_reference(arch, mlp_type):
    """The arch's layer-0 MLP weights; gelu runs on its wi / wo."""
    cfg, _, jp, p = models(arch)
    jm = _layer0(jp["stack0_dense_attn"])["mlp"]
    pm = tf.tree_map(lambda a: a[0], p["stack0_dense_attn"])["mlp"]
    x = np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.mlp_apply(jm, jnp.asarray(x), mlp_type)
    got = layers.mlp_apply(pm, torch.from_numpy(x), mlp_type)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("quant", ["none", "binary_weights", "binary",
                                   "packed"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_matches_reference(arch, quant):
    """``dense`` on the arch's layer-0 wq, in all four forms; the packed
    form is the reference's ``dense_packed_from`` carried over, and the
    port's own fold must equal it."""
    cfg, _, jp, p = models(arch)
    jw = _layer0(jp["stack0_dense_attn"])["attn"]["wq"]
    pw = tf.tree_map(lambda a: a[0], p["stack0_dense_attn"])["attn"]["wq"]
    x = np.random.default_rng(4).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    if quant == "packed":
        jw = jlayers.dense_packed_from(jw["w"])
        ours = layers.dense_packed_from(pw["w"])
        pw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
        torch.testing.assert_close(ours["w_packed"], pw["w_packed"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(ours["alpha"], pw["alpha"], **F32)
    q = "binary" if quant == "packed" else quant
    want = jlayers.dense(jw, jnp.asarray(x), q)
    got = layers.dense(pw, torch.from_numpy(x), q)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_gqa_forward_matches_reference(arch, qk_norm):
    cfg, jcfg, jp, p = models(arch)
    cfg, jcfg = cfg.with_(qk_norm=qk_norm), jcfg.with_(qk_norm=qk_norm)
    ja = _layer0(jp["stack0_dense_attn"])["attn"]
    pa = tf.tree_map(lambda a: a[0], p["stack0_dense_attn"])["attn"]
    if qk_norm and not models(arch)[0].qk_norm:      # give it norm scales
        rng = np.random.default_rng(5)
        for name in ("q_norm", "k_norm"):
            s = rng.uniform(0.5, 1.5, cfg.head_dim).astype(np.float32)
            ja = {**ja, name: {"scale": jnp.asarray(s)}}
            pa = {**pa, name: {"scale": torch.from_numpy(s)}}
    x = np.random.default_rng(6).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)[None, :]
    want = jattn.gqa_forward(ja, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attention.gqa_forward(pa, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ------------------------------------------------------------ whole forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_and_prefill_match_reference(arch, dtype):
    cfg, jcfg, jp, p = models(arch, dtype)
    toks = _tokens(cfg, (2, 16))
    jb = jt.Batch(jnp.asarray(toks, jnp.int32), jnp.asarray(toks, jnp.int32))
    want = _np(jt.forward_train(jcfg, jp, jb)[0])
    logits, aux = tf.forward_train(cfg, p, tf.Batch(torch.from_numpy(toks),
                                                    torch.from_numpy(toks)))
    assert logits.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    assert float(aux) == 0.0
    got = _np(logits)
    pre = tf.prefill(cfg, p, torch.from_numpy(toks))
    want_pre = _np(jt.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32)))
    tol = F32 if dtype == "float32" else BF16
    # the head's matmul blocks (B, 1, d) and (B, S, d) apart
    np.testing.assert_allclose(_np(pre), got[:, -1:], **tol)
    for g, w in ((got, want), (_np(pre), want_pre)):
        np.testing.assert_allclose(g, w, **tol)
        top2 = np.sort(w, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol["atol"]
        assert np.all((g.argmax(-1) == w.argmax(-1)) | ~clear)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_matches_decode_loop(arch):
    """The K7 path (prefill) against the cache path (decode_step fed the
    prompt token by token), in the port alone."""
    cfg, _, _, p = models(arch)
    toks = torch.from_numpy(_tokens(cfg, (1, 13), seed=7))
    want = tf.prefill(cfg, p, toks)[0, -1]
    state = tf.init_serve_state(cfg, 1, 16)
    for i in range(toks.shape[1]):
        logits, state = tf.decode_step(cfg, p, state, toks[:, i:i + 1])
    torch.testing.assert_close(logits[0, -1], want, **F32)
    assert int(state.length) == 13
    assert state.caches.length.tolist() == [[13]] * cfg.n_layers


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_steps_match_reference(arch):
    """Three decode steps over 3 slots at lengths 0, 3 and 7 in a cache of
    8 filled with the same random K/V: slot 2 runs past the cache, where
    both drop the write and attend to every row."""
    cfg, jcfg, jp, p = models(arch)
    b, max_len = 3, 8
    rng = np.random.default_rng(8)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    lens = np.broadcast_to(np.array([0, 3, 7]), (cfg.n_layers, b))
    jstate = jt.ServeState(
        jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                      jnp.asarray(lens, jnp.int32)), None,
        jnp.zeros((), jnp.int32))
    state = tf.init_serve_state(cfg, b, max_len)
    state.caches.k.copy_(torch.from_numpy(k0))
    state.caches.v.copy_(torch.from_numpy(v0))
    state.caches.length.copy_(torch.from_numpy(lens.copy()))
    for step in range(3):
        toks = _tokens(cfg, (b, 1), seed=20 + step)
        want, jstate = jt.decode_step(jcfg, jp, jstate,
                                      jnp.asarray(toks, jnp.int32))
        got, state = tf.decode_step(cfg, p, state, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(state.caches.k), _np(jstate.caches.k),
                               **F32)
    np.testing.assert_allclose(_np(state.caches.v), _np(jstate.caches.v),
                               **F32)
    np.testing.assert_array_equal(state.caches.length.numpy(),
                                  np.asarray(jstate.caches.length))
    assert int(state.length) == int(jstate.length) == 3


# ------------------------------------------------------------------ serving
MIXED = ([3, 7, 5, 2, 6], 6)            # prompt lengths, max_new


def _prompts(cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in MIXED[0]]


def _serve(eng, prompts, max_new=MIXED[1]):
    rids = [eng.submit(pr, max_new_tokens=max_new) for pr in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_serving_engine_matches_reference(arch):
    cfg, jcfg, jp, p = models(arch)
    prompts = _prompts(cfg)
    want = _serve(JServingEngine(jcfg, jp, n_slots=3, max_len=24), prompts)
    eng = ServingEngine(cfg, p, n_slots=3, max_len=24, device="cpu")
    assert isinstance(eng.model, TransformerServeModel)
    assert _serve(eng, prompts) == want
    assert all(len(t) == MIXED[1] for t in want)


def test_engine_slot_independence_and_reuse():
    """A request's tokens do not depend on its co-tenants, and a reused
    slot serves like a fresh engine (the reference's invariants)."""
    cfg, _, _, p = models("qwen3-8b")
    prompts = _prompts(cfg)
    alone = _serve(ServingEngine(cfg, p, n_slots=4, max_len=24,
                                 device="cpu"), prompts[:1])[0]
    shared = _serve(ServingEngine(cfg, p, n_slots=4, max_len=24,
                                  device="cpu"), prompts)
    assert shared[0] == alone
    one_slot = _serve(ServingEngine(cfg, p, n_slots=1, max_len=24,
                                    device="cpu"), prompts[:2])
    fresh = _serve(ServingEngine(cfg, p, n_slots=1, max_len=24,
                                 device="cpu"), prompts[1:2])[0]
    assert one_slot[1] == fresh


def test_swap_params_keeps_storage():
    cfg, _, _, p = models("qwen3-8b")
    p2 = models("qwen3-8b", seed=1)[3]
    before = [t.clone() for t in tf.tree_leaves(p)]
    prompts = _prompts(cfg)
    eng = ServingEngine(cfg, p, n_slots=3, max_len=24, device="cpu")
    first = _serve(eng, prompts)
    ptrs = [t.data_ptr() for t in eng.params]
    eng.swap_params(eng.model.swap_arrays(p2))
    assert [t.data_ptr() for t in eng.params] == ptrs
    # the caller's tree is untouched: the engine swapped its own copies
    assert all(torch.equal(a, b) for a, b in zip(before, tf.tree_leaves(p)))
    after = _serve(eng, prompts)
    fresh = _serve(ServingEngine(cfg, p2, n_slots=3, max_len=24,
                                 device="cpu"), prompts)
    assert after == fresh and after != first


def test_swap_rejects_mismatched_tree():
    cfg, _, _, p = models("qwen3-8b")
    eng = ServingEngine(cfg, p, n_slots=2, max_len=16, device="cpu")
    other = models("yi-6b")[3]                 # no qk-norm scales
    with pytest.raises(ValueError, match="differs"):
        eng.model.swap_arrays(other)
    wide = tf.tree_map(lambda t: t, p)
    wide["final_norm"] = {"scale": torch.ones(cfg.d_model + 1)}
    with pytest.raises(ValueError, match="differs"):
        eng.model.swap_arrays(wide)
    with pytest.raises(ValueError):
        eng.swap_params(eng.params[:-1])


@pytest.mark.parametrize("quant", ["none", "binary", "binary_weights"])
def test_serve_cli_dense_cpu(capsys, quant):
    kfa.flash_attention.launches = 0
    assert serve.main(["--device", "cpu", "--arch", "qwen3-8b", "--smoke",
                       "--quant", quant, "--swap", "--requests", "3",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out and "hot-swap OK" in out
    assert kfa.flash_attention.launches == 0
