"""The port's executable LM stage pipeline (``parallel/pipeline.py::
pipelined_forward`` and ``sequential_forward`` over a ``launch/mesh.py``
mesh of CPU devices) against the live reference's ``sequential_forward``.

The reference's own ``pipelined_forward`` raises under jax 0.9.0 (a
sharded ``zeros_like`` gather), so both port forms are held against the
reference's oracle: allclose at rtol = atol = 1e-5 in float32 (the
tolerance of ``tests/test_torch_transformer.py``: the two packages sum in
different orders), and bitwise equal to each other (on one device each
microbatch meets the same layers in the same order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.parallel import pipeline as jpp
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.parallel import pipeline as pp

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_stages: int):
    return mesh_lib.make_mesh((n_stages,), ("stage",),
                              devices=["cpu"] * n_stages)


def toy(seed: int = 0):
    """The reference test's stack: L = 8 layers of tanh(x @ w), D = 16,
    8 microbatches of (4, D); numpy in, both packages' forms out."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 4, 16)).astype(np.float32)
    want = np.asarray(jpp.sequential_forward(
        {"w": jnp.asarray(w)}, jnp.asarray(x),
        apply_fn=lambda lp, h: jnp.tanh(h @ lp["w"])))
    return {"w": torch.from_numpy(w)}, torch.from_numpy(x), want


def toy_fn(lp, h):
    return torch.tanh(h @ lp["w"])


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_toy_stack_pipelined_equals_sequential_and_reference(n_stages):
    stack, x, want = toy()
    seq = pp.sequential_forward(stack, x, apply_fn=toy_fn)
    got = pp.pipelined_forward(stack, x, mesh=cpu_mesh(n_stages),
                               axis="stage", apply_fn=toy_fn,
                               layers_per_stage=8 // n_stages)
    assert torch.equal(got, seq)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_sequential_forward_on_one_microbatch():
    stack, x, want = toy()
    got = pp.sequential_forward(stack, x[3], apply_fn=toy_fn)
    np.testing.assert_allclose(got.numpy(), want[3], **F32)


@functools.lru_cache(maxsize=None)
def qwen3_cut(n_layers: int = 4):
    """(port cfg, reference cfg, reference stack, port stack): the Qwen3
    smoke config cut to ``n_layers`` narrow layers, float32."""
    jcfg = jconfigs.get_config("qwen3-8b", smoke=True).with_(
        n_layers=n_layers, dtype="float32")
    cfg = configs.get_config("qwen3-8b", smoke=True).with_(
        n_layers=n_layers, dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    port = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return cfg, jcfg, jp["stack0_dense_attn"], port["stack0_dense_attn"]


def qwen3_fn(cfg):
    def apply(lp, h):
        return tf._apply_dense_attn(
            lp, cfg, h, torch.arange(h.shape[1], device=h.device)[None])
    return apply


@pytest.mark.parametrize("n_stages", [2, 4])
def test_qwen3_cut_pipelined_equals_sequential_and_reference(n_stages):
    cfg, jcfg, jstack, stack = qwen3_cut()
    x = np.random.default_rng(1).standard_normal(
        (8, 2, 16, cfg.d_model)).astype(np.float32)     # (n_micro, B, S, D)
    pos = jnp.arange(16)[None]
    want = np.asarray(jpp.sequential_forward(
        jstack, jnp.asarray(x),
        apply_fn=lambda lp, h: jt._apply_dense_attn(lp, jcfg, h, pos)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        seq = pp.sequential_forward(stack, xt, apply_fn=qwen3_fn(cfg))
        got = pp.pipelined_forward(stack, xt, mesh=cpu_mesh(n_stages),
                                   axis="stage", apply_fn=qwen3_fn(cfg),
                                   layers_per_stage=cfg.n_layers // n_stages)
    assert torch.equal(got, seq)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_qwen3_cut_sequential_equals_decoder_stack():
    """Each microbatch through the stacked layers == the model's own
    ``_decoder_stack`` on it."""
    cfg, _, _, stack = qwen3_cut()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1, 16, cfg.d_model)).astype(np.float32))
    params = {"stack0_dense_attn": stack}
    with torch.no_grad():
        seq = pp.sequential_forward(stack, x, apply_fn=qwen3_fn(cfg))
        for m in range(x.shape[0]):
            h, _ = tf._decoder_stack(cfg, params, x[m],
                                     torch.arange(16)[None])
            assert torch.equal(seq[m], h)


def test_microbatches_must_fill_the_stages():
    stack, x, _ = toy()
    with pytest.raises(ValueError, match="multiple"):
        pp.pipelined_forward(stack, x[:6], mesh=cpu_mesh(4), axis="stage",
                             apply_fn=toy_fn, layers_per_stage=2)
    with pytest.raises(ValueError, match="layers"):
        pp.pipelined_forward(stack, x, mesh=cpu_mesh(4), axis="stage",
                             apply_fn=toy_fn, layers_per_stage=3)


def test_two_axis_mesh_runs_along_its_stage_axis():
    stack, x, want = toy()
    mesh = mesh_lib.make_mesh((2, 2), ("stage", "model"),
                              devices=["cpu"] * 4)
    got = pp.pipelined_forward(stack, x, mesh=mesh, axis="stage",
                               apply_fn=toy_fn, layers_per_stage=4)
    np.testing.assert_allclose(got.numpy(), want, **F32)
