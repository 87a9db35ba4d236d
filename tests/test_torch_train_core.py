"""The port's training graph of the Table 2 BCNN against the live JAX
reference on the CPU: the STEs, the train halves of ``core/blinear.py``,
``core/bconv.py`` and ``core/bcnn.py``, at full Table 2 width where the
whole net runs. Inputs are numpy arrays from a seed, handed to both.

Tolerances and why:

* the STEs: bitwise, forward and gradient (``where`` on the same float32
  values, including |x| = 1 and x = 0);
* ``blinear.apply_train`` / ``bconv.apply_train`` (stored BN statistics):
  outputs and gradients allclose at rtol = atol = 1e-5. The ±1 products
  are integer-valued and exact; the BN is the same IEEE float32 sequence;
  the weight gradients sum float products in another order;
* CONV-1's training conv (``fpconv_train``): allclose at rtol = 1e-5,
  atol = 1e-4 (sums of 27 products of 6-bit integers with the scaled
  2-bit weights, in another order); its weight gradient at relative L2
  1e-5;
* ``forward_train`` layer by layer, each layer fed the reference's input:
  z allclose at rtol = atol = 1e-4 (batch statistics reduce 2048–8192
  values in another order), batch mean / unbiased variance at rtol =
  1e-5, atol = 1e-4, and a binarize decision may differ only where
  |z| < 1e-3, as in ``tests/test_torch_bcnn.py``;
* ``loss_fn``: loss at rtol 1e-5, every gradient leaf within relative L2
  1e-4 of the reference's (float sums in another order; a flipped
  binarize decision would show as a far larger gap);
* the max-pool gradient with ties goes to the first maximum of each 2×2
  window in row-major order on both sides: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import binarize as jbin
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro_torch.core import bcnn, bconv, binarize, blinear
from repro_torch.data.pipeline import SyntheticImages

# batch 4: at batch 2 the FCs' batch-stat BN normalizes each value to
# about ±1 and its backward cancels almost exactly, so both sides' float32
# gradients keep only ~3 digits (8e-4 apart measured); at 4 they agree to
# 2e-6
BATCH = 4


def to_jax(cls, q):
    return cls(*[jnp.asarray(np.asarray(getattr(q, f))) for f in cls._fields])


def jax_params(p) -> jbcnn.BCNNParams:
    """Numpy latent params as the reference's BCNNParams."""
    return jbcnn.BCNNParams(
        conv1=to_jax(jbconv.FpConvParams, p.conv1),
        convs=tuple(to_jax(jbconv.BConvParams, q) for q in p.convs),
        fcs=tuple(to_jax(jblinear.BLinearParams, q) for q in p.fcs))


def torch_leaves(p, fields=("w", "bn_gamma", "bn_beta")):
    """The differentiable leaves of a layer, as tensors needing grad."""
    return {f: torch.tensor(np.asarray(getattr(p, f)), requires_grad=True)
            for f in fields}


# ---------------------------------------------------------------- the STEs
STE_X = np.array([-2.0, -1.0000001, -1.0, -0.5, -0.0, 0.0, 1e-30, 0.5,
                  1.0, 1.0000001, 3.0], np.float32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_binarize_ste_forward_and_gradient_bitwise(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([STE_X, rng.normal(0, 1.5, 53).astype(np.float32)])
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want_y, vjp = jax.vjp(jbin.binarize_ste, jx)
    (want_g,) = vjp(jg)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tx = torch.tensor(x).to(tdt).requires_grad_()
    y = binarize.binarize_ste(tx)
    (got_g,) = torch.autograd.grad(y, tx, torch.tensor(g).to(tdt))
    assert y.dtype == tdt and got_g.dtype == tdt
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(want_g, np.float32))
    # |x| = 1 passes the gradient, just beyond it does not; 0 → +1
    np.testing.assert_array_equal(
        got_g.float().numpy()[:len(STE_X)] != 0,
        np.abs(np.asarray(jnp.asarray(STE_X, dtype), np.float32)) <= 1)
    assert y.detach().float().numpy()[4:6].tolist() == [1.0, 1.0]


def test_binarize_ste_without_grad_is_the_bare_forward():
    x = torch.tensor(STE_X, requires_grad=True)
    with torch.no_grad():
        y = binarize.binarize_ste(x)
    assert y.grad_fn is None
    np.testing.assert_array_equal(
        y.numpy(), binarize.binarize_ste(x.detach()).numpy())
    assert binarize.binarize_weights(x).grad_fn is not None
    np.testing.assert_array_equal(
        binarize.clip_latent(torch.tensor(STE_X)).numpy(),
        np.asarray(jbin.clip_latent(jnp.asarray(STE_X))))


def test_quant2_ste_identity_gradient():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, (16, 3, 3, 3)).astype(np.float32)
    g = rng.normal(0, 1, w.shape).astype(np.float32)
    want_y, vjp = jax.vjp(jbin.quantize_weight_2bit, jnp.asarray(w))
    (want_g,) = vjp(jnp.asarray(g))
    tw = torch.tensor(w, requires_grad=True)
    y = binarize.quantize_weight_2bit(tw)
    (got_g,) = torch.autograd.grad(y, tw, torch.tensor(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_g.numpy(), g)      # identity to w
    q, scale = binarize.quantize_weight_2bit_parts(torch.tensor(w))
    np.testing.assert_array_equal((q * scale).numpy(), y.detach().numpy())


# ------------------------------------------------- layers with stored BN
def _bn_layer(rng, o, scale):
    return dict(bn_mean=rng.normal(0, 0.3 * np.sqrt(scale), o),
                bn_var=rng.uniform(0.5, 2.0, o) * scale,
                bn_gamma=rng.uniform(0.5, 1.5, o) * rng.choice([-1, 1], o),
                bn_beta=rng.normal(0, 0.3, o))


def _f32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _grads_close(got: dict, want, rtol=1e-5, atol=1e-5):
    for f, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("binarize_out", [True, False])
def test_blinear_apply_train_and_gradients(binarize_out):
    rng = np.random.default_rng(2)
    i, o = 96, 40
    npp = _f32(dict(w=rng.uniform(-1.3, 1.3, (o, i)), **_bn_layer(rng, o, i)))
    a = np.where(rng.random((5, i)) < 0.5, -1.0, 1.0).astype(np.float32)
    r = rng.normal(0, 1, (5, o)).astype(np.float32)
    jp = jblinear.BLinearParams(**{k: jnp.asarray(v) for k, v in npp.items()})

    def jloss(p, a):
        return jnp.sum(jblinear.apply_train(p, a, binarize_out=binarize_out)
                       * r)
    want = jblinear.apply_train(jp, jnp.asarray(a), binarize_out=binarize_out)
    jg, jga = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(a))

    leaves = torch_leaves(jp)
    ta = torch.tensor(a, requires_grad=True)
    tp = blinear.BLinearParams(
        bn_mean=torch.tensor(npp["bn_mean"]),
        bn_var=torch.tensor(npp["bn_var"]), **leaves)
    got = blinear.apply_train(tp, ta, binarize_out=binarize_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((got * torch.tensor(r)).sum(),
                                [*leaves.values(), ta])
    _grads_close(dict(zip(leaves, grads[:3])), jg)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(jga),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("maxpool", [False, True])
def test_bconv_apply_train_and_gradients(maxpool):
    rng = np.random.default_rng(3)
    c, o, h = 24, 16, 6
    npp = _f32(dict(w=rng.uniform(-1.2, 1.2, (o, 3, 3, c)),
                    **_bn_layer(rng, o, 9.0 * c)))
    a = np.where(rng.random((2, h, h, c)) < 0.5, -1.0, 1.0).astype(np.float32)
    oh = h // 2 if maxpool else h
    r = rng.normal(0, 1, (2, oh, oh, o)).astype(np.float32)
    jp = jbconv.BConvParams(**{k: jnp.asarray(v) for k, v in npp.items()})

    def jloss(p, a):
        return jnp.sum(jbconv.apply_train(p, a, binarize_out=False,
                                          maxpool=maxpool) * r)
    want = jbconv.apply_train(jp, jnp.asarray(a), maxpool=maxpool)
    jg, jga = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(a))

    leaves = torch_leaves(jp)
    ta = torch.tensor(a, requires_grad=True)
    tp = bconv.BConvParams(bn_mean=torch.tensor(npp["bn_mean"]),
                           bn_var=torch.tensor(npp["bn_var"]), **leaves)
    got = bconv.apply_train(tp, ta, maxpool=maxpool)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    z = bconv.apply_train(tp, ta, binarize_out=False, maxpool=maxpool)
    grads = torch.autograd.grad((z * torch.tensor(r)).sum(),
                                [*leaves.values(), ta])
    _grads_close(dict(zip(leaves, grads[:3])), jg)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(jga),
                               rtol=1e-5, atol=1e-5)


def test_conv1_train_forward_and_weight_gradient():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.1, (16, 3, 3, 3)).astype(np.float32)
    x = rng.random((2, 8, 8, 3)).astype(np.float32)
    r = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)

    def jconv(w):                    # CONV-1 of the reference forward_train
        return jax.lax.conv_general_dilated(
            jbin.quantize_input_6bit(jnp.asarray(x)),
            jnp.transpose(jbin.quantize_weight_2bit(w), (1, 2, 3, 0)),
            (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = jconv(jnp.asarray(w))
    jg = jax.grad(lambda w: jnp.sum(jconv(w) * r))(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    p = bconv.FpConvParams(w=tw, bn_mean=None, bn_var=None, bn_gamma=None,
                           bn_beta=None)
    got = bconv.fpconv_train(p, torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    (g,) = torch.autograd.grad((got * torch.tensor(r)).sum(), tw)
    assert np.linalg.norm(g.numpy() - jg) <= 1e-5 * np.linalg.norm(jg)


def test_maxpool_tie_gradient_goes_to_first_maximum():
    """Binary conv outputs are integers, so 2×2 windows tie often: both
    sides send the gradient to the first maximum in row-major order."""
    y = np.array([[3, 3, 1, 2], [3, 0, 2, 2],
                  [-1, 5, 4, 4], [5, 5, 4, 4]], np.float32)
    y = np.stack([y, y.T], -1)[None]                   # (1, 4, 4, 2) NHWC
    r = np.array([[[[1.0, 2.0], [3.0, 4.0]], [[5.0, 6.0], [7.0, 8.0]]]],
                 np.float32)

    def jpool(y):
        return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                     (1, 2, 2, 1), "VALID")
    jg = jax.grad(lambda y: jnp.sum(jpool(y) * r))(jnp.asarray(y))
    ty = torch.tensor(y, requires_grad=True)
    out = bconv.maxpool2x2(ty)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jpool(jnp.asarray(y))))
    (g,) = torch.autograd.grad((out * torch.tensor(r)).sum(), ty)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    # channel 0's first window [[3, 3], [3, 0]] ties three ways: (0, 0) wins
    assert g.numpy()[0, :2, :2, 0].tolist() == [[1.0, 0.0], [0.0, 0.0]]


# ---------------------------------------------- the whole net, full width
def ref_layer(jp, idx, a):
    """Layer ``idx`` of the reference's ``forward_train``, from its own
    primitives: (z, (mean, unbiased var))."""
    dn = ("NHWC", "HWIO", "NHWC")
    if idx == 0:
        p = jp.conv1
        y = jax.lax.conv_general_dilated(
            jbin.quantize_input_6bit(a),
            jnp.transpose(jbin.quantize_weight_2bit(p.w), (1, 2, 3, 0)),
            (1, 1), "SAME", dimension_numbers=dn)
    elif idx <= 5:
        p = jp.convs[idx - 1]
        fh, fw = p.w.shape[1], p.w.shape[2]
        ap = jnp.pad(a, ((0, 0), (fh // 2, fh // 2), (fw // 2, fw // 2),
                         (0, 0)), constant_values=-1.0)
        y = jax.lax.conv_general_dilated(
            ap, jnp.transpose(jbin.binarize_ste(p.w), (1, 2, 3, 0)), (1, 1),
            "VALID", dimension_numbers=dn)
        if jbcnn.CONV_SPECS[idx][2]:
            y = jax.lax.reduce_window(y, -jnp.inf, jax.lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    else:
        p = jp.fcs[idx - 6]
        y = a.reshape(a.shape[0], -1) @ jbin.binarize_ste(p.w).T
    axes = (0,) if idx >= 6 else (0, 1, 2)
    z, m, v = jbcnn._bn_train(y, p.bn_gamma, p.bn_beta, axes)
    return z, (m, v)


@pytest.fixture(scope="module")
def net():
    npp = bcnn.numpy_params(0)
    x, y = SyntheticImages(global_batch=BATCH, seed=0).batch(0)
    return npp, jax_params(npp), x, y


@pytest.fixture(scope="module")
def ref_chain(net):
    """Each layer's input, z and stats in the reference; the chain is
    checked bitwise against the live ``forward_train``."""
    _, jp, x, _ = net
    ins, zs, stats = [jnp.asarray(x)], [], []
    for idx in range(jbcnn.N_LAYERS):
        z, st = ref_layer(jp, idx, ins[-1])
        zs.append(z)
        stats.append(st)
        ins.append(jbin.binarize_ste(z) if idx < jbcnn.N_LAYERS - 1 else z)
    logits, want_stats = jbcnn.forward_train(jp, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ins[-1]), np.asarray(logits))
    for (m, v), (wm, wv) in zip(stats, want_stats):
        np.testing.assert_array_equal(np.asarray(m), np.asarray(wm))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(wv))
    return ([np.asarray(a) for a in ins], [np.asarray(z) for z in zs],
            [(np.asarray(m), np.asarray(v)) for m, v in stats])


@pytest.mark.parametrize("idx", range(jbcnn.N_LAYERS))
def test_forward_train_layer_matches_reference(net, ref_chain, idx):
    npp = net[0]
    ins, zs, stats = ref_chain
    z, (m, v) = bcnn.train_layer(bcnn.params_from_numpy(npp), idx,
                                 torch.tensor(ins[idx]))
    z = z.detach().numpy()
    assert z.shape == zs[idx].shape and z.dtype == np.float32
    np.testing.assert_allclose(z, zs[idx], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m.detach().numpy(), stats[idx][0],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v.detach().numpy(), stats[idx][1],
                               rtol=1e-5, atol=1e-4)
    if idx < bcnn.N_LAYERS - 1:
        flip = (z >= 0) != (zs[idx] >= 0)
        assert (np.abs(zs[idx][flip]) < 1e-3).all()


def test_forward_train_chain_logits_and_stats(net, ref_chain):
    npp, _, x, _ = net
    logits, stats = bcnn.forward_train(bcnn.params_from_numpy(npp),
                                       torch.tensor(x))
    assert logits.shape == (BATCH, 10) and len(stats) == bcnn.N_LAYERS
    np.testing.assert_allclose(logits.detach().numpy(), ref_chain[0][-1],
                               rtol=1e-4, atol=1e-4)
    assert [tuple(m.shape) for m, _ in stats] == [
        (o,) for _, o, _ in bcnn.CONV_SPECS] + [(o,) for _, o in
                                              bcnn.FC_SPECS]


def test_loss_fn_value_and_gradients_match_reference(net):
    npp, jp, x, y = net
    (want, _), jg = jax.value_and_grad(jbcnn.loss_fn, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(y))
    tp = bcnn.params_from_numpy(npp)
    layers = [tp.conv1, *tp.convs, *tp.fcs]
    jlayers = [jg.conv1, *jg.convs, *jg.fcs]
    for p in layers:
        for f in ("w", "bn_gamma", "bn_beta"):
            getattr(p, f).requires_grad_()
    loss, _ = bcnn.loss_fn(tp, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    leaves = [getattr(p, f) for p in layers
              for f in ("w", "bn_gamma", "bn_beta")]
    grads = torch.autograd.grad(loss, leaves)
    wants = [np.asarray(getattr(p, f)) for p in jlayers
             for f in ("w", "bn_gamma", "bn_beta")]
    for g, w in zip(grads, wants):
        assert g.shape == w.shape
        gap = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert gap <= 1e-4, gap
    # the running statistics get no gradient in either
    for p in jlayers:
        assert not np.asarray(p.bn_mean).any() and not np.asarray(
            p.bn_var).any()


def test_update_running_stats_matches_reference(net, ref_chain):
    npp, jp, _, _ = net
    stats = ref_chain[2]
    want = jbcnn.update_running_stats(
        jp, [(jnp.asarray(m), jnp.asarray(v)) for m, v in stats])
    got = bcnn.update_running_stats(
        bcnn.params_from_numpy(npp),
        [(torch.tensor(m), torch.tensor(v)) for m, v in stats])
    for gl, wl in zip([got.conv1, *got.convs, *got.fcs],
                      [want.conv1, *want.convs, *want.fcs]):
        for f in ("w", "bn_mean", "bn_var", "bn_gamma", "bn_beta"):
            np.testing.assert_array_equal(getattr(gl, f).numpy(),
                                          np.asarray(getattr(wl, f)))


def test_forward_eval_matches_reference_and_packed(net):
    npp, jp, x, _ = net
    tp = bcnn.params_from_numpy(npp)
    got = bcnn.forward_eval(tp, torch.tensor(x)).numpy()
    want = np.asarray(jbcnn.forward_eval(jp, jnp.asarray(x)))
    assert got.shape == (BATCH, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    packed = bcnn.forward_packed(bcnn.fold_model(tp), torch.tensor(x),
                                 path="xla").numpy()
    np.testing.assert_allclose(got, packed, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), packed.argmax(1))


def test_init_distributions():
    g = torch.Generator().manual_seed(0)
    p = blinear.init(g, 300, 200)
    assert p.w.shape == (200, 300) and -1 <= float(p.w.min()) < -0.99
    assert float(p.w.max()) > 0.99 and float(p.bn_var.min()) == 1.0
    c = bconv.init(g, 8, 16)
    assert c.w.shape == (16, 3, 3, 8) and float(c.w.abs().max()) <= 1.0
    f = bconv.fpconv_init(g, 3, 128)
    assert f.w.shape == (128, 3, 3, 3)
    assert abs(float(f.w.std()) - 0.1) < 0.01
