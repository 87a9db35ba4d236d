"""The port's optimizer (``train/optimizer.py``) and checkpoints
(``train/checkpoint.py``) against the live JAX reference on the CPU.

* AdamW: three steps on a random tree in three configurations (the
  defaults with the global-norm clip and weight decay active, the BCNN
  recipe's ``make_adamw``, the unit latent clip): params, moments, step and
  grad norm allclose at rtol = 1e-5, atol = 1e-7 (the same float32
  sequence of operations; ``b ** step`` may round differently by an ulp);
* ``compress_decompress``: three rounds of error feedback at rtol = 1e-6,
  atol = 1e-6 (each leaf's scale is a mean summed in another order, and
  an ulp of it, ~1e-7 at scale ~1, lands in every residual);
* checkpoints: the reference's behaviour tests (roundtrip, latest and
  retention, CRC corruption, same-step re-save, interrupted re-save, .tmp
  litter), and the on-disk format both ways, bfloat16 leaves included:
  bitwise.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.train import bcnn_train as jbt
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.core import bcnn
from repro_torch.train import bcnn_train
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.train import tree


def random_tree(rng, scale=1.0):
    """A small dict/tuple tree of float32 numpy arrays."""
    return {"b": (rng.normal(0, scale, (3, 4)).astype(np.float32),
                  rng.normal(0, scale, (5,)).astype(np.float32)),
            "a": rng.normal(0, scale, (2, 3, 2)).astype(np.float32)}


def to_torch(t):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), t)


def to_jnp(t):
    return jax.tree.map(jnp.asarray, t)


def assert_tree_close(got, want, **tol):
    gl = tree.tree_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


CONFIGS = {
    "defaults": dict(),
    "bcnn_recipe": dict(lr=2e-3, b2=0.999, weight_decay=0.0,
                        grad_clip=float("inf")),
    "unit_clip": dict(lr=0.5, weight_decay=0.01, clip_latent_unit=True,
                      grad_clip=3.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_adamw_matches_reference(name):
    rng = np.random.default_rng(0)
    params = random_tree(rng, 0.8)
    jo, to = jopt.AdamW(**CONFIGS[name]), opt.AdamW(**CONFIGS[name])
    jp, tp = to_jnp(params), to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for _ in range(3):
        grads = random_tree(rng, 2.0)
        jp, js, jn = jo.update(to_jnp(grads), js, jp)
        tp, ts, tn = to.update(to_torch(grads), ts, tp)
        tol = dict(rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert_tree_close(tp, jp, **tol)
        assert_tree_close(ts.m, js.m, **tol)
        assert_tree_close(ts.v, js.v, **tol)
        assert int(ts.step) == int(js.step)
    if CONFIGS[name].get("clip_latent_unit"):
        assert all(float(x.abs().max()) <= 1.0 for x in tree.tree_leaves(tp))


def dict_tree(rng):
    """``random_tree`` without tuples: the reference's
    ``compress_decompress`` takes every tuple in a tree for a (q, e) pair
    (its ``is_leaf``), so only tuple-free trees reach it intact."""
    t = random_tree(rng)
    return {"a": t["a"], "b": {"c": t["b"][0], "d": t["b"][1]}}


def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(1)
    params = dict_tree(rng)
    jef, tef = jopt.ef_init(to_jnp(params)), opt.ef_init(to_torch(params))
    for _ in range(3):
        grads = dict_tree(rng)
        jq, jef = jopt.compress_decompress(to_jnp(grads), jef)
        tq, tef = opt.compress_decompress(to_torch(grads), tef)
        assert_tree_close(tq, jq, rtol=1e-6, atol=1e-6)
        assert_tree_close(tef.residual, jef.residual, rtol=1e-6, atol=1e-6)


def test_compress_decompress_on_tuple_trees_is_per_leaf():
    """The port keeps (named) tuples in the tree: each leaf is compressed
    on its own, as the reference does on tuple-free trees."""
    rng = np.random.default_rng(2)
    grads = random_tree(rng)
    tq, tef = opt.compress_decompress(to_torch(grads),
                                      opt.ef_init(to_torch(grads)))
    flat = {"a": grads["a"], "b": {"c": grads["b"][0], "d": grads["b"][1]}}
    jq, jef = jopt.compress_decompress(to_jnp(flat),
                                       jopt.ef_init(to_jnp(flat)))
    assert isinstance(tq["b"], tuple) and len(tq["b"]) == 2
    assert_tree_close(tq, jq, rtol=1e-6, atol=1e-6)
    assert_tree_close(tef.residual, jef.residual, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- checkpoints
def port_tree(seed=0):
    """A tree with float32, bfloat16, int32 0-d and None leaves."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((4, 5), generator=g)
    return {"params": (w, torch.randn((3,), generator=g).bfloat16()),
            "opt": opt.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                  m=(w * 0.5,), v=(w * w,)),
            "none": None}


def jax_like(t):
    """The same tree in JAX arrays (bfloat16 through ml_dtypes)."""
    def conv(x):
        if x is None:
            return None
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy().astype(ml_dtypes.bfloat16))
        return jnp.asarray(x.numpy())
    return {"params": tuple(conv(x) for x in t["params"]),
            "opt": jopt.AdamWState(step=conv(t["opt"].step),
                                   m=(conv(t["opt"].m[0]),),
                                   v=(conv(t["opt"].v[0]),)),
            "none": None}


def assert_trees_equal(a, b):
    la, lb = tree.leaves_with_path(a), tree.leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if x is None:
            assert y is None, k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def test_save_restore_roundtrip(tmp_path):
    state = port_tree()
    ck.save(str(tmp_path), 7, state)
    got, step = ck.restore(str(tmp_path), state)
    assert step == 7
    assert_trees_equal(state, got)


def test_latest_and_retention(tmp_path):
    state = port_tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, state, keep=3)
    assert ck.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(str(tmp_path))) == [
        "step_00000003", "step_00000004", "step_00000005"]
    assert ck.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "absent"), state)


def test_crc_detects_corruption(tmp_path):
    state = port_tree()
    ck.save(str(tmp_path), 1, state)
    cdir = tmp_path / "step_00000001"
    man = json.loads((cdir / "manifest_p0.json").read_text())
    victim = next(m["file"] for m in man["leaves"].values() if "file" in m)
    raw = bytearray((cdir / victim).read_bytes())
    raw[-1] ^= 0xFF
    (cdir / victim).write_bytes(bytes(raw))
    with pytest.raises(ck.CorruptCheckpoint):
        ck.restore(str(tmp_path), state)


def test_missing_leaf_raises(tmp_path):
    state = port_tree()
    ck.save(str(tmp_path), 1, state)
    bigger = dict(state, extra=torch.zeros(2))
    with pytest.raises(ck.CorruptCheckpoint, match="extra"):
        ck.restore(str(tmp_path), bigger)


def test_resave_same_step(tmp_path):
    """Re-saving a committed step replaces it (os.replace cannot replace
    a non-empty directory: the old copy is retired first)."""
    state = port_tree()
    ck.save(str(tmp_path), 5, state)
    new_state = tree.tree_map(lambda x: None if x is None else x + 1, state)
    ck.save(str(tmp_path), 5, new_state)
    got, step = ck.restore(str(tmp_path), state)
    assert step == 5
    assert_trees_equal(new_state, got)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000005"]


def test_interrupted_resave_recovers(tmp_path):
    """A crash between the two renames leaves only the .retired copy: it
    rolls back, and a retired copy whose commit landed is removed."""
    state = port_tree()
    ck.save(str(tmp_path), 7, state)
    final = str(tmp_path / "step_00000007")
    os.replace(final, final + ".retired")
    assert ck.latest_step(str(tmp_path)) == 7
    got, step = ck.restore(str(tmp_path), state)
    assert step == 7
    assert_trees_equal(state, got)
    ck.save(str(tmp_path), 7, state)
    os.makedirs(final + ".retired")
    ck.save(str(tmp_path), 8, state)
    assert not os.path.exists(final + ".retired")


def test_tmp_litter_is_ignored_and_gcd(tmp_path):
    state = port_tree()
    ck.save(str(tmp_path), 1, state)
    litter = tmp_path / "step_00000009.tmp"
    os.makedirs(litter)
    assert ck.latest_step(str(tmp_path)) == 1
    ck.save(str(tmp_path), 2, state)
    assert not litter.exists()


def test_port_checkpoint_restores_in_reference(tmp_path):
    state = port_tree(3)
    ck.save(str(tmp_path), 4, state)
    template = jax.eval_shape(lambda: jax_like(state))
    got, step = jck.restore(str(tmp_path), template)
    assert step == 4
    want = jax_like(state)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(x)).view(np.uint8),
            np.atleast_1d(np.asarray(y)).view(np.uint8))
    assert got["none"] is None


def test_reference_checkpoint_restores_in_port(tmp_path):
    state = port_tree(4)
    jck.save(str(tmp_path), 6, jax_like(state))
    got, step = ck.restore(str(tmp_path), state)
    assert step == 6
    assert_trees_equal(state, got)
    assert got["params"][1].dtype == torch.bfloat16


def test_bcnn_train_state_keys_match_reference(tmp_path):
    """The 136 leaves of a ``BCNNTrainState`` carry the reference's keys
    (``params/conv1/w``, ``opt/m/fcs/2/bn_beta``, ``opt/step``) and file
    names, so either package reads the other's manifest."""
    adamw = bcnn_train.make_adamw()
    params = bcnn.params_from_numpy(bcnn.numpy_params(0))
    state = bcnn_train.BCNNTrainState(params=params, opt=adamw.init(params))
    ck.save(str(tmp_path), 1, state)
    man = json.loads((tmp_path / "step_00000001" /
                      "manifest_p0.json").read_text())
    jstate = jbt.init_state(jax.random.PRNGKey(0), jbt.make_adamw())
    jkeys = list(jck._flatten(jstate))
    assert list(man["leaves"]) == jkeys and len(jkeys) == 136
    assert {"params/conv1/w", "params/convs/0/w", "opt/m/fcs/2/bn_beta",
            "opt/step"} <= set(jkeys)
    assert man["format"] == 1 and man["step"] == 1
    meta = man["leaves"]["opt/step"]
    assert meta["dtype"] == "int32" and meta["shape"] == []
    got, _ = jck.restore(str(tmp_path), jax.eval_shape(lambda: jstate))
    for (k, x), y in zip(tree.leaves_with_path(state),
                         jax.tree.leaves(got)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=k)
    assert isinstance(got.params, jbcnn.BCNNParams)
