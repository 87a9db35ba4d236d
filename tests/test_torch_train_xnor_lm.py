"""The XNOR LM's training forward in the port (``models/xnor_lm.py``
``forward_train`` / ``loss_fn``) and the synthetic data pipelines
(``data/pipeline.py``) against the live JAX reference on the CPU, on the
same numpy latent params (``numpy_params``: random BN statistics, γ of
both signs) and the same seeded data.

* The port's eager ``forward_train`` equals its ``forward_packed`` bit
  for bit in both kernel modes: the ±1 float32 products are
  integer-valued and equal the packed agree-counts, and the float spine
  is the same sequence of ops (the reference's contract,
  ``tests/test_xnor_lm.py``).
* Against the reference: logits allclose at rtol = atol = 1e-5 with the
  same argmax (RMSNorm, rsqrt and softmax sum in another order, as in
  ``tests/test_torch_xnor_lm.py``); ``loss_fn`` at rtol 1e-5 and every
  gradient leaf within relative L2 1e-4, plus 1e-8 absolute: the K
  projection's BN mean and β are a per-head bias of the keys, which the
  softmax cancels, so their gradients are 0 up to rounding (~1e-10).
* ``SyntheticLM`` / ``SyntheticImages``: equal to the reference's arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blinear as jblinear
from repro.data import pipeline as jpipe
from repro.models import xnor_lm as jxl
from repro_torch import configs
from repro_torch.data import pipeline, synthetic
from repro_torch.models import xnor_lm as xl
from repro_torch.train import tree

CFG = xl.XnorLMConfig(vocab_size=32, d_model=32, n_layers=2, n_heads=2,
                      d_ff=32, max_len=32)
CONFIGS = {"cfg": CFG, "smoke": configs.get_config("xnor-lm-tiny",
                                                    smoke=True)}


def to_jax(p) -> jxl.XnorLMParams:
    """Numpy latent params as the reference's XnorLMParams."""
    def blin(b):
        return jblinear.BLinearParams(*[jnp.asarray(getattr(b, f))
                                        for f in jblinear.BLinearParams._fields])
    blocks = tuple(jxl.XnorBlockParams(
        ln1=jnp.asarray(b.ln1), wq=blin(b.wq), wk=blin(b.wk), wv=blin(b.wv),
        wo=blin(b.wo), ln2=jnp.asarray(b.ln2), w_up=blin(b.w_up),
        w_down=blin(b.w_down)) for b in p.blocks)
    return jxl.XnorLMParams(
        tok_embed=jnp.asarray(p.tok_embed), pos_embed=jnp.asarray(p.pos_embed),
        blocks=blocks, ln_f=jnp.asarray(p.ln_f), w_head=jnp.asarray(p.w_head))


def jcfg(cfg):
    return jxl.XnorLMConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff", "max_len")})


def lm_batch(cfg, batch=3, seq=12, seed=0):
    return pipeline.SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batch(5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["bw", "xnor"])
def test_forward_train_equals_forward_packed_bitwise(name, mode):
    cfg = CONFIGS[name]
    params = xl.params_from_numpy(xl.numpy_params(cfg, 0))
    toks = lm_batch(cfg).tokens
    got = xl.forward_train(cfg, params, toks)
    want = xl.forward_packed(cfg, xl.fold(cfg, params), toks, mode=mode,
                             path="xla")
    assert got.shape == (3, 12, cfg.vocab_size)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_train_matches_reference(name):
    cfg = CONFIGS[name]
    npp = xl.numpy_params(cfg, 1)
    toks = lm_batch(cfg, seed=1).tokens
    got = xl.forward_train(cfg, xl.params_from_numpy(npp), toks).numpy()
    want = np.asarray(jxl.forward_train(jcfg(cfg), to_jax(npp),
                                        jnp.asarray(toks.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_fn_and_gradients_match_reference(name):
    cfg = CONFIGS[name]
    npp = xl.numpy_params(cfg, 2)
    batch = lm_batch(cfg, seed=2)
    jp = to_jax(npp)
    want, jg = jax.value_and_grad(
        lambda p: jxl.loss_fn(jcfg(cfg), p, jnp.asarray(batch.tokens.numpy()),
                              jnp.asarray(batch.targets.numpy())))(jp)
    params = tree.tree_map(lambda t: t.requires_grad_(),
                           xl.params_from_numpy(npp))
    loss = xl.loss_fn(cfg, params, batch.tokens, batch.targets)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    leaves = tree.leaves_with_path(params)
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for (key, _), g, w in zip(leaves, grads, jleaves):
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, key
        gap = np.linalg.norm(g.numpy() - w)
        assert gap <= 1e-4 * np.linalg.norm(w) + 1e-8, key
    assert len(leaves) == 4 + cfg.n_layers * (2 + 6 * 5)


def test_synthetic_lm_equals_reference():
    for kw in (dict(), dict(n_shards=2, shard=1, frontend=(3, 8))):
        ours = pipeline.SyntheticLM(64, 20, 4, seed=7, **kw)
        ref = jpipe.SyntheticLM(64, 20, 4, seed=7, **kw)
        np.testing.assert_array_equal(ours.motifs, ref.motifs)
        for step in (0, 3):
            a, b = ours.batch(step), ref.batch(step)
            assert a.tokens.dtype == torch.int32
            np.testing.assert_array_equal(a.tokens.numpy(), b.tokens)
            np.testing.assert_array_equal(a.targets.numpy(), b.targets)
            if kw:
                np.testing.assert_array_equal(a.frontend.numpy(), b.frontend)
            else:
                assert a.frontend is None and b.frontend is None
    with pytest.raises(ValueError):
        pipeline.SyntheticLM(64, 20, 5, n_shards=2)


def test_synthetic_images_equal_reference():
    assert synthetic.SyntheticImages is pipeline.SyntheticImages
    for kw in (dict(), dict(n_shards=4, shard=3)):
        ours = pipeline.SyntheticImages(global_batch=8, seed=3, **kw)
        ref = jpipe.SyntheticImages(global_batch=8, seed=3, **kw)
        for step in (0, 10_000):
            (x, y), (rx, ry) = ours.batch(step), ref.batch(step)
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
