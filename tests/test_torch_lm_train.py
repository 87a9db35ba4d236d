"""The port's LM training loss (``repro_torch/models/transformer.py::
loss_fn``) and its gradients on the CPU against the live JAX reference
(``jax.value_and_grad`` of ``repro/models/transformer.py::loss_fn``), for
every architecture of ``configs.ARCH_NAMES`` (smoke configs), and the
attention rule under autograd (K7 raises; the blockwise plain attention
runs).

Both sides run on the reference's ``init_params`` tree carried across by
``params_from_numpy``, on the same ``SyntheticLM`` batch (the vlm and
audio families with their stub frontends). Tolerances, each with its
reason:

* float32 (``remat`` on, so every layer runs under
  ``torch.utils.checkpoint`` as the reference's under ``jax.checkpoint``):
  loss rtol 1e-5; each gradient leaf within relative L2 1e-4 of the
  reference's, plus an absolute 1e-8 for leaves whose gradient is about
  0 (float sums in another order: 1e-7 to 5e-6 measured). A MoE token
  routed to another expert set would move the gradients far more, so
  this bar also requires equal routing.

``tests/test_torch_lm_train_bf16.py`` holds the same sweep in bfloat16;
``tests/test_torch_lm_train_step.py`` the rest of the training path: the
quant modes, the CE chunks, remat, the train step and the checkpoints.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import frontend_shape
from repro_torch.models import attention, mla
from repro_torch.models import transformer as tf
from repro_torch.train import train_loop, tree

ARCHS = configs.ARCH_NAMES
BATCH, SEQ = 2, 64
LOSS_F32, GRAD_F32, GRAD_ABS = 1e-5, 1e-4, 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype, remat):
    return (configs.get_config(arch, smoke=True).with_(dtype=dtype,
                                                       remat=remat),
            jconfigs.get_config(arch, smoke=True).with_(dtype=dtype,
                                                        remat=remat))


@functools.lru_cache(maxsize=None)
def reference_tree(arch: str, dtype: str):
    """The reference's ``init_params`` tree in ``dtype``."""
    _, jcfg = _configs(arch, dtype, False)
    return jax.jit(jt.init_params, static_argnums=0)(jcfg,
                                                     jax.random.PRNGKey(0))


def batch_for(cfg):
    """(port Batch, reference Batch) of ``SyntheticLM``'s first batch."""
    b = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0,
                    frontend=frontend_shape(cfg)).batch(0)
    fe = None if b.frontend is None else jnp.asarray(b.frontend.numpy())
    return b, jt.Batch(jnp.asarray(b.tokens.numpy()),
                       jnp.asarray(b.targets.numpy()), fe)


@functools.lru_cache(maxsize=None)
def reference_grads(arch: str, dtype: str, remat: bool):
    """(loss, [gradient leaves as float32 numpy]) of the reference."""
    cfg, jcfg = _configs(arch, dtype, remat)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))
    (loss, _), g = f(reference_tree(arch, dtype), batch_for(cfg)[1])
    return float(loss), [np.asarray(a, np.float32) for a in jax.tree.leaves(g)]


def port_grads(arch, dtype, remat):
    """(loss, nll, [(path, float32 numpy gradient)]) of the port."""
    cfg, _ = _configs(arch, dtype, remat)
    params = tf.params_from_numpy(cfg, jax.tree.map(
        np.asarray, reference_tree(arch, dtype)))
    loss, nll, g = train_loop.value_and_grad(cfg, params, batch_for(cfg)[0])
    leaves = tree.tree_leaves(params)
    assert all(a.dtype == p.dtype and a.shape == p.shape
               for a, p in zip(tree.tree_leaves(g), leaves))
    return float(loss), float(nll), [
        (k, a.to(torch.float32).numpy()) for k, a in tree.leaves_with_path(g)]


def rel_l2(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(‖got − want‖, ‖want‖) in float64."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(got - want)), float(np.linalg.norm(want))


def assert_f32_grads(got, want):
    assert len(got) == len(want)
    for (key, g), w in zip(got, want):
        assert g.shape == w.shape, key
        err, norm = rel_l2(g, w)
        assert err <= GRAD_F32 * norm + GRAD_ABS, (key, err, norm)


# ---------------------------------------------------------------- float32
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32_match_reference(arch):
    want_loss, want = reference_grads(arch, "float32", True)
    loss, nll, got = port_grads(arch, "float32", True)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_F32)
    if configs.get_config(arch).family != "moe":
        assert nll == loss                    # aux is 0 outside the moe
    assert_f32_grads(got, want)


# --------------------------------------------------------- the K7 guard
def _qkv(shape=(1, 4, 16, 8), kv_heads=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, h, s, hd = shape
    return (torch.randn((b, h, s, hd), generator=g),
            torch.randn((b, kv_heads, s, hd), generator=g),
            torch.randn((b, kv_heads, s, hd), generator=g))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_raises_under_autograd(which):
    q, k, v = _qkv()
    ins = dict(q=q, k=k, v=v)
    ins[which] = ins[which].clone().requires_grad_()
    for fn in (ops.flash_attention, kfa.flash_attention):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(ins["q"], ins["k"], ins["v"], causal=True)
    # no grad mode, or no input that requires grad: the plain version
    with torch.no_grad():
        out = ops.flash_attention(ins["q"], ins["k"], ins["v"])
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v, causal=True))
    # the CPU tensors reach the device check only outside autograd
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(ins["q"], ins["k"], ins["v"])


def _count_flash(monkeypatch):
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("arch,causal", [("qwen3-8b", True),
                                         ("whisper-medium", False)])
def test_gqa_forward_under_grad_is_the_blockwise_path(arch, causal,
                                                      monkeypatch):
    cfg, jcfg = _configs(arch, "float32", False)
    jp = jax.tree.map(lambda a: a[0], reference_tree(
        arch, "float32")["stack0_dec_xattn" if cfg.family == "audio"
                         else "stack0_dense_attn"])["attn"]
    p = tree.tree_map(torch.from_numpy, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40)[None, :]
    want = jattn.gqa_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             causal=causal)
    calls = _count_flash(monkeypatch)
    live = tree.tree_map(lambda t: t.clone().requires_grad_(), p)
    got = attention.gqa_forward(live, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), causal=causal)
    assert not calls and got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got.square().sum(),
                                tree.tree_leaves(live))
    assert all(bool(g.abs().sum() > 0) for g in grads)
    with torch.no_grad():
        attention.gqa_forward(live, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), causal=causal)
    assert len(calls) == 1


def test_mla_forward_under_grad_is_the_blockwise_path(monkeypatch):
    cfg, jcfg = _configs("deepseek-v2-236b", "float32", False)
    jp = jax.tree.map(lambda a: a[0], reference_tree(
        "deepseek-v2-236b", "float32")["stack0_dense_attn_mla"])["attn"]
    p = tree.tree_map(torch.from_numpy, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)[None, :]
    want = jmla.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    calls = _count_flash(monkeypatch)
    live = tree.tree_map(lambda t: t.clone().requires_grad_(), p)
    got = mla.mla_forward(live, cfg, torch.from_numpy(x),
                          torch.from_numpy(pos))
    assert not calls and got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got.square().sum(), tree.tree_leaves(live))
    assert all(bool(g.abs().sum() > 0) for g in grads)
    with torch.no_grad():
        mla.mla_forward(live, cfg, torch.from_numpy(x),
                        torch.from_numpy(pos))
    assert len(calls) == 1


def test_forward_train_without_grad_keeps_k7_and_values():
    """A forward on parameters that do not require grad (prefill,
    serving, phases on the card) still calls ``ops.flash_attention``
    once per attention layer, and equals the blockwise path within
    float32 rounding."""
    cfg, _ = _configs("qwen3-8b", "float32", False)
    params = tf.params_from_numpy(cfg, jax.tree.map(
        np.asarray, reference_tree("qwen3-8b", "float32")))
    b = batch_for(cfg)[0]
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    ops.flash_attention = counted
    try:
        plain, _ = tf.forward_train(cfg, params, b)
        live = tree.tree_map(lambda t: t.clone().requires_grad_(), params)
        blockwise, _ = tf.forward_train(cfg, live, b)
    finally:
        ops.flash_attention = real
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(blockwise.detach().numpy(), plain.numpy(),
                               rtol=1e-5, atol=1e-5)
