"""The port's LM training loss and gradients in bfloat16 on the CPU
against the live JAX reference (``jax.value_and_grad`` of
``repro/models/transformer.py::loss_fn``), for every architecture of
``configs.ARCH_NAMES`` (smoke configs, ``remat`` off); the float32 sweep
is ``tests/test_torch_lm_train.py``.

Both sides run on the reference's bfloat16 ``init_params`` tree (its
float32 tree cast leaf by leaf to the bfloat16 tree's dtypes, as the
reference draws in float32 and casts) carried across by
``params_from_numpy``, on the same ``SyntheticLM`` batch. Tolerances,
each with its reason:

* loss at the zoo's ``BF16`` rtol (2e-2);
* each gradient leaf within relative L2 2e-2 (``BF16``'s rtol) of the
  reference's bf16 gradient, or within 1.5x the reference's own
  distance from the float32 gradient where that is larger: both
  packages round bf16 activations in different places, and the port's
  bf16 gradients measured 0.65-1.19x the reference's own bf16 noise (up
  to 0.155 on a MoE router, whose top-k routing flips at near-ties).
  The float32 gradient is the port's on the float32 tree, which
  ``tests/test_torch_lm_train.py`` holds within 1e-4 of the
  reference's: a stand-in a hundred times closer than the noise it
  measures, at no second compile of the reference.
* The moe archs record both routers: a token routed differently must be
  a near-tie of the reference's router (relative gap below 0.05, the
  routing rule of ``tests/test_torch_deepseek.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import frontend_shape
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train import train_loop, tree

ARCHS = configs.ARCH_NAMES
BATCH, SEQ = 2, 64
BF16_REL = 2e-2                 # the zoo's BF16 rtol
BF16_REF_NOISE = 1.5
GRAD_ABS = 1e-8
ROUTE_MARGIN = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded_routes(monkeypatch):
    """Record (expert_idx, probs) of every MoE layer call, as numpy, in
    the reference (through ``jax.debug.callback``) and the port."""
    got_ref, got_port = [], []
    j_apply, t_route = jmoe.moe_apply, moe.route

    def j_recorded(p, cfg, x):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"],
                               axis=-1)
        idx = jax.lax.top_k(probs, cfg.top_k)[1]
        jax.debug.callback(lambda i, pr: got_ref.append(
            (np.asarray(i), np.asarray(pr))), idx, probs, ordered=True)
        return j_apply(p, cfg, x)

    def t_recorded(p, cfg, x):
        out = t_route(p, cfg, x)
        got_port.append((out[2].numpy(), out[0].detach().numpy()))
        return out
    monkeypatch.setattr(jmoe, "moe_apply", j_recorded)
    monkeypatch.setattr(moe, "route", t_recorded)
    return got_ref, got_port


def _rel(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(got - want)), float(np.linalg.norm(want))


def _port_grads(cfg, tree_np, batch) -> list[np.ndarray]:
    params = tf.params_from_numpy(cfg, tree_np)
    _, _, g = train_loop.value_and_grad(cfg, params, batch)
    return [a.to(torch.float32).numpy() for a in tree.tree_leaves(g)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bfloat16_match_reference(arch, monkeypatch):
    cfg32 = configs.get_config(arch, smoke=True).with_(dtype="float32",
                                                       remat=False)
    cfg = cfg32.with_(dtype="bfloat16")
    jcfg32 = jconfigs.get_config(arch, smoke=True).with_(dtype="float32",
                                                         remat=False)
    jcfg = jcfg32.with_(dtype="bfloat16")
    jp32 = jax.jit(jt.init_params, static_argnums=0)(jcfg32,
                                                     jax.random.PRNGKey(0))
    spec = jax.eval_shape(lambda: jt.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a, s: a.astype(s.dtype), jp32, spec)
    b = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0,
                    frontend=frontend_shape(cfg)).batch(0)
    jb = jt.Batch(jnp.asarray(b.tokens.numpy()),
                  jnp.asarray(b.targets.numpy()),
                  None if b.frontend is None
                  else jnp.asarray(b.frontend.numpy()))
    routed = cfg.family == "moe"
    if routed:
        routes_ref, routes_port = _recorded_routes(monkeypatch)
    (wl, _), wg = jax.jit(jax.value_and_grad(
        lambda p, bb: jt.loss_fn(jcfg, p, bb), has_aux=True))(jp, jb)
    jax.effects_barrier()
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(wg)]
    params = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    loss, _, g = train_loop.value_and_grad(cfg, params, b)
    got = tree.leaves_with_path(g)
    assert all(a.dtype == p.dtype for a, p in zip(tree.tree_leaves(g),
                                                  tree.tree_leaves(params)))
    np.testing.assert_allclose(float(loss), float(wl), rtol=BF16_REL)
    if routed:
        k = cfg.top_k
        assert len(routes_ref) == len(routes_port) > 0
        for (ji, jpr), (ti, _) in zip(routes_ref, routes_port):
            differ = np.any(np.sort(ji, -1) != np.sort(ti, -1), axis=-1)
            top = -np.sort(-jpr, axis=-1)
            gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
            assert np.all(gap[differ] < ROUTE_MARGIN), gap[differ]
        monkeypatch.undo()
    anchor = _port_grads(cfg32, jax.tree.map(np.asarray, jp32), b)
    assert len(got) == len(want) == len(anchor)
    for (key, a), w, w32 in zip(got, want, anchor):
        err, norm = _rel(a.to(torch.float32).numpy(), w)
        noise = _rel(w, w32)[0]
        bar = max(BF16_REL * norm, BF16_REF_NOISE * noise) + GRAD_ABS
        assert err <= bar, (key, err, norm, noise)
