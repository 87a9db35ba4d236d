"""The port's packed Table 2 BCNN against the JAX reference, at full
Table 2 width and batch 2, on the same numpy latent params (random BN
statistics, γ of both signs) and the same images.

Tolerances and why:

* layers CONV-2..FC-2 (indices 1..7), each fed the reference's input:
  bits / packed words exactly equal — integer arithmetic on both sides;
* FC-3 logits (index 8, and the whole forward): ``allclose(rtol=1e-5,
  atol=1e-5)`` and the same argmax. The Norm is the same IEEE float32
  sequence on both sides (and is in fact equal here), but the reference
  itself only promises allclose + argmax for float outputs;
* CONV-1 bits: a bit may differ only where |z| < 1e-3. The port computes
  the conv as an exact integer dot times the weight scale, the reference
  rounds each partial sum of its float conv, so z differs by float32
  rounding (~1e-7 here) and a bit can flip only where z is that close
  to 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bcnn_artifact as jart
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro_torch.core import bcnn, bcnn_artifact, bconv, execution_plan
from repro_torch.data.synthetic import SyntheticImages

STRATEGIES = ["direct", "im2col"]


def jax_params(p) -> jbcnn.BCNNParams:
    """The port's numpy latent params as the reference's BCNNParams."""
    def conv(cls, q):
        return cls(*[jnp.asarray(getattr(q, f)) for f in cls._fields])
    return jbcnn.BCNNParams(
        conv1=conv(jbconv.FpConvParams, p.conv1),
        convs=tuple(conv(jbconv.BConvParams, q) for q in p.convs),
        fcs=tuple(conv(jblinear.BLinearParams, q) for q in p.fcs))


@pytest.fixture(scope="module")
def nets():
    npp = bcnn.numpy_params(0)
    return (jbcnn.fold_model(jax_params(npp)),
            bcnn.fold_model(bcnn.params_from_numpy(npp)))


@pytest.fixture(scope="module")
def images():
    x, _ = SyntheticImages(global_batch=2, seed=0).batch(0)
    return x


@pytest.fixture(scope="module")
def jax_chain(nets, images):
    """Every layer's input/output in the reference, path "xla", both
    strategies (which the reference keeps bit-identical)."""
    jpk, _ = nets
    chains = {}
    for strategy in STRATEGIES:
        hs = [jnp.asarray(images)]
        for idx in range(jbcnn.N_LAYERS):
            hs.append(jbcnn.apply_packed_layer(
                jpk, idx, hs[-1], path="xla", conv_strategy=strategy))
        chains[strategy] = [np.asarray(h) for h in hs]
    return chains


def _leaf_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(b, torch.Tensor):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    else:
        assert a == b


def test_fold_model_leaves_equal_jax(nets):
    jpk, tpk = nets
    jleaves = dict(jart._walk(jpk))
    tleaves = dict(bcnn_artifact.walk(tpk))
    assert list(jleaves) == list(tleaves)
    for key in jleaves:
        _leaf_equal(jleaves[key], tleaves[key])
    flips = [c.thr.flip for c in tpk.convs] + [f.thr.flip for f in tpk.fcs]
    assert all(f.any() and not f.all() for f in flips)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_layers_match_jax_fed_jax_input(nets, jax_chain, strategy):
    _, tpk = nets
    hs = jax_chain[strategy]
    for idx in range(1, bcnn.N_LAYERS):
        got = bcnn.apply_packed_layer(tpk, idx, torch.tensor(hs[idx]),
                                      path="xla", conv_strategy=strategy)
        want = hs[idx + 1]
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        if idx == bcnn.N_LAYERS - 1:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"layer {idx}")


def test_conv1_bits_differ_only_near_zero(nets, images):
    jpk, tpk = nets
    z_j = np.asarray(jbconv.fpconv_apply(jpk.conv1, jnp.asarray(images),
                                         binarize_out=False))
    z_t = bconv.fpconv_apply(tpk.conv1, torch.from_numpy(images),
                             binarize_out=False).numpy()
    assert z_t.shape == z_j.shape == (2, 32, 32, 128)
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5, atol=1e-5)
    bits_t = bcnn.apply_packed_layer(tpk, 0, torch.from_numpy(images)).numpy()
    diff = bits_t != (z_j >= 0)
    assert (np.abs(z_j[diff]) < 1e-3).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_forward_logits_match_jax(nets, images, jax_chain, strategy):
    _, tpk = nets
    want = jax_chain[strategy][-1]
    got = bcnn.forward_packed(tpk, torch.from_numpy(images), path="xla",
                              conv_strategy=strategy).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_artifact_from_jax_loads_leaf_for_leaf(nets, tmp_path):
    jpk, tpk = nets
    jart.save_packed(str(tmp_path), jpk, provenance={"steps": 3})
    loaded = bcnn_artifact.load_packed(str(tmp_path))
    tleaves = dict(bcnn_artifact.walk(tpk))
    for key, leaf in bcnn_artifact.walk(loaded):
        _leaf_equal(tleaves[key].numpy() if isinstance(tleaves[key],
                                                       torch.Tensor)
                    else tleaves[key], leaf)
    assert bcnn_artifact.load_manifest(str(tmp_path))["provenance"][
        "steps"] == 3


def test_artifact_corruption_and_version_rejected(nets, tmp_path):
    jpk, _ = nets
    jart.save_packed(str(tmp_path), jpk)
    manifest = bcnn_artifact.load_manifest(str(tmp_path))
    wpath = tmp_path / manifest["weights_file"]
    with np.load(wpath) as npz:
        arrays = dict(npz)
    arrays["convs.2.w_words"][0, 0] ^= 1          # one flipped weight bit
    with open(wpath, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(bcnn_artifact.ArtifactError, match="CRC"):
        bcnn_artifact.load_packed(str(tmp_path))
    mpath = tmp_path / bcnn_artifact.MANIFEST
    text = mpath.read_text()
    mpath.write_text(text.replace('"version": 2', '"version": 99'))
    with pytest.raises(bcnn_artifact.ArtifactError, match="version"):
        bcnn_artifact.load_packed(str(tmp_path))


def test_plan_resolution_and_fusion_not_ported(nets):
    """Plan resolution; fusion, once refused here, now plans the two
    Table 2 pairs with the port's default tiles (tests/test_torch_fused.py
    holds the fused forward against the reference)."""
    _, tpk = nets
    plan = execution_plan.build_plan(tpk, device="cpu")
    assert plan.path == "xla"
    assert plan.conv_strategy == (None,) + ("direct",) * 5 + (None,) * 3
    assert not plan.conv_fusion and plan.group_tiles == ()
    assert execution_plan.resolve_path("auto", "cuda") == "mxu"
    assert execution_plan.resolve_path("vpu", "cpu") == "vpu"
    assert execution_plan.default_plan(tpk, "cpu") == plan
    fused = execution_plan.build_plan(tpk, device="cpu", conv_fusion=True)
    assert fused.conv_fusion
    assert bcnn.plan_layer_groups(conv_fusion=fused.conv_fusion) == (
        (0,), (1,), (2, 3), (4, 5), (6,), (7,), (8,))
    assert fused.group_tiles == ((2, 1, 2), (4, 1, 1))
    assert fused.tiles_for(2) == (1, 2) and fused.tiles_for(4) == (1, 1)
    with pytest.raises(ValueError):
        execution_plan.resolve_path("tpu")
