"""The port's Multi-head Latent Attention (``repro_torch/models/mla.py``)
on the CPU against the live JAX reference (``repro/models/mla.py``), on
the reference's ``mla_init`` weights carried across as numpy arrays and
the same seeded numpy inputs: deepseek-v2-lite-16b's smoke widths (no
q-LoRA) and deepseek-v2-236b's (q-LoRA).

On the CPU the port's prefill attention is K7's plain version with q and
k at qk_nope + qk_rope and v at its own v_head_dim; the reference's is its
blockwise scan on v zero-padded to q's width. Tolerances: float32 rtol =
atol = 1e-5; bfloat16 at the LM zoo's ``BF16`` (rtol 2e-2, atol 6.25e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mla as jmla
from repro_torch import configs
from repro_torch.models import mla
from repro_torch.models import transformer as tf

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
# the reference compiled once per (cfg, shape), not op by op
jmla_forward = jax.jit(jmla.mla_forward, static_argnums=1)
jmla_decode = jax.jit(jmla.mla_decode_step, static_argnums=1)



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
def attn_layer(arch: str, dtype: str = "float32"):
    """(port cfg, reference cfg, reference MLA params, port params)."""
    jcfg = jconfigs.get_config(arch, smoke=True).with_(dtype=dtype)
    cfg = configs.get_config(arch, smoke=True).with_(dtype=dtype)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.jit(jmla.mla_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, dt)
    return cfg, jcfg, jp, tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_init_matches_reference_tree(arch):
    cfg, jcfg, _, _ = attn_layer(arch)
    jp = jax.eval_shape(lambda: jmla.mla_init(jax.random.PRNGKey(0), jcfg,
                                              jnp.bfloat16))
    p = mla.mla_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    assert ("wq_a" in p) == bool(cfg.q_lora_rank) == ("wq" not in p)


@pytest.mark.parametrize("quant", ["none", "binary_weights", "binary"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_forward_matches_reference(arch, quant):
    cfg, jcfg, jp, p = attn_layer(arch)
    cfg, jcfg = cfg.with_(quant=quant), jcfg.with_(quant=quant)
    x = np.random.default_rng(1).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)[None, :]
    want = jmla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = mla.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert got.shape == (2, 11, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_forward_bf16_matches_reference(arch):
    cfg, jcfg, jp, p = attn_layer(arch, "bfloat16")
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)[None, :]
    want = jmla_forward(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(pos))
    got = mla.mla_forward(p, cfg, torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, dtype):
    cfg, jcfg, _, _ = attn_layer(arch)
    dts = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jmla.init_cache(jcfg, 3, 8, dts[0])
    got = mla.init_cache(cfg, 3, 8, dts[1])
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not bool(g.any())
    assert got.c_kv.dtype == got.k_rope.dtype == dts[1]
    # lengths are int64 in the port (torch's index dtype), int32 there
    assert got.length.dtype == torch.int64


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_steps_match_reference(arch):
    """Four absorbed decode steps over 3 slots at lengths 0, 3 and 6 in a
    cache of 8 filled with the same random latents: slot 2 reaches the
    cache's end at the third step, where both drop the write and attend
    to every row."""
    cfg, jcfg, jp, p = attn_layer(arch)
    b, max_len = 3, 8
    rng = np.random.default_rng(3)
    c0 = rng.standard_normal((b, max_len, cfg.kv_lora_rank)).astype(
        np.float32)
    r0 = rng.standard_normal((b, max_len, cfg.qk_rope_head_dim)).astype(
        np.float32)
    lens = np.array([0, 3, 6])
    jcache = jmla.MLACache(jnp.asarray(c0), jnp.asarray(r0),
                           jnp.asarray(lens, jnp.int32))
    cache = mla.MLACache(torch.from_numpy(c0.copy()),
                         torch.from_numpy(r0.copy()),
                         torch.from_numpy(lens.copy()))
    for step in range(4):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jmla_decode(jp, jcfg, jnp.asarray(x), jcache)
        got, same = mla.mla_decode_step(p, cfg, torch.from_numpy(x), cache)
        assert same is cache                        # updated in place
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(cache.c_kv), _np(jcache.c_kv), **F32)
    np.testing.assert_allclose(_np(cache.k_rope), _np(jcache.k_rope), **F32)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    # slot 2's length counts on past max_len; its last two writes were
    # dropped, as the reference's (the caches above are equal)
    assert cache.length.tolist() == [4, 7, 10]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_absorbed_decode(arch):
    """At quant="none" the expanded prefill (K7's plain version) and the
    absorbed decode fed token by token are one function."""
    cfg, _, _, p = attn_layer(arch)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    want = mla.mla_forward(p, cfg, x, torch.arange(9)[None, :])
    cache = mla.init_cache(cfg, 2, 9, torch.float32)
    got = torch.cat([mla.mla_decode_step(p, cfg, x[:, i:i + 1], cache)[0]
                     for i in range(9)], dim=1)
    torch.testing.assert_close(got, want, **F32)


# DeepSeek-V2's head widths (both sizes): q and k at 128 + 64 = 192, v at
# 128, on the smoke model's other widths
HEAD_WIDTHS = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


@functools.lru_cache(maxsize=None)
def wide_heads_layer(arch: str):
    """``attn_layer`` at ``HEAD_WIDTHS``, float32."""
    jcfg = jconfigs.get_config(arch, smoke=True).with_(**HEAD_WIDTHS)
    cfg = configs.get_config(arch, smoke=True).with_(**HEAD_WIDTHS)
    jp = jax.jit(jmla.mla_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(5), jcfg, jnp.float32)
    return cfg, jcfg, jp, tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


def _recorded_flash(monkeypatch) -> list:
    """Record the (q, k, v) shapes of every ``ops.flash_attention`` call
    ``mla_forward`` makes."""
    from repro_torch.kernels import ops
    calls, real = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", recorded)
    return calls


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_forward_at_full_head_widths(arch, grad, monkeypatch):
    """At DeepSeek-V2's head widths the no-grad forward hands K7's entry
    point v unpadded, (B, H, S, 128) under q and k at 192 (K7 "tc"'s
    shape on the card in bf16), and equals the reference's forward, which
    pads v to 192 and slices it back. Under autograd it takes the
    blockwise route (no K7 call), pads v there, and equals it too."""
    cfg, jcfg, jp, p = wide_heads_layer(arch)
    b, s = 2, 11
    x = np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s)[None, :]
    want = jmla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    calls = _recorded_flash(monkeypatch)
    if grad:
        p = tf.tree_map(lambda t: t.clone().requires_grad_(), p)
    got = mla.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    h = cfg.n_heads
    if grad:
        assert not calls and got.grad_fn is not None
    else:
        assert calls == [((b, h, s, 192), (b, h, s, 192), (b, h, s, 128))]
    assert got.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
