"""Bit layer of the PyTorch port against the JAX reference: packing,
popcount dot, threshold folding, the BN oracle and the first-layer
quantizers, on the same numpy-seeded inputs. Everything here is held to
exact equality: the port repeats the reference's integer and IEEE
float32 arithmetic op for op."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin
from repro.core import bitpack as jbp
from repro.core import normbinarize as jnb
from repro_torch.core import binarize as tbin
from repro_torch.core import bitpack as tbp
from repro_torch.core import normbinarize as tnb

RAGGED_K = [1, 31, 32, 33, 70, 1000, 1152]


@pytest.mark.parametrize("k", RAGGED_K)
def test_pack_bits_matches_jax(k):
    bits = np.random.default_rng(k).integers(0, 2, (3, 5, k)).astype(np.int8)
    want = np.asarray(jbp.pack_bits(jbp.pad_to_pack(jnp.asarray(bits))))
    got = tbp.pack_bits(tbp.pad_to_pack(torch.from_numpy(bits)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # words with bit 31 set (>= 2**31 unsigned) wrap to negative int32
    assert (want < 0).any() or k < 32


def test_pack_bits_high_words():
    bits = np.ones((2, 64), np.int8)
    bits[1, 31] = 0
    got = tbp.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbp.pack_bits(jnp.asarray(bits))))
    assert got[0, 0] == -1 and got[1, 0] == 2 ** 31 - 1


@pytest.mark.parametrize("k", RAGGED_K)
def test_unpack_and_pack_pm1_match_jax(k):
    rng = np.random.default_rng(100 + k)
    x = rng.normal(size=(4, k)).astype(np.float32)
    want = np.asarray(jbp.pack_pm1(jnp.asarray(x)))
    got = tbp.pack_pm1(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbp.unpack_bits(got, k).numpy(),
        np.asarray(jbp.unpack_bits(jnp.asarray(want), k)))
    np.testing.assert_array_equal(
        tbp.decode_pm1(tbp.encode_pm1(torch.from_numpy(x))).numpy(),
        np.where(x >= 0, 1.0, -1.0))


@pytest.mark.parametrize("k", RAGGED_K)
def test_xnor_dot_matches_jax(k):
    rng = np.random.default_rng(200 + k)
    a = tbp.pack_pm1(torch.from_numpy(rng.normal(size=(6, k))))
    w = tbp.pack_pm1(torch.from_numpy(rng.normal(size=(6, k))))
    want = np.asarray(jbp.xnor_dot(jnp.asarray(a.numpy()),
                                   jnp.asarray(w.numpy()), k))
    np.testing.assert_array_equal(tbp.xnor_dot(a, w, k).numpy(), want)


def _bn(rng, o, scale):
    return (rng.normal(0, 0.3 * np.sqrt(scale), o).astype(np.float32),
            (rng.uniform(0.5, 2.0, o) * scale).astype(np.float32),
            (rng.uniform(0.5, 1.5, o) * rng.choice([-1, 1], o)
             ).astype(np.float32),
            rng.normal(0, 0.3, o).astype(np.float32))


@pytest.mark.parametrize("cnum", [27, 1152, 8192])
@pytest.mark.parametrize("rounded", [True, False])
def test_fold_threshold_matches_jax(cnum, rounded):
    rng = np.random.default_rng(cnum)
    mean, var, gamma, beta = _bn(rng, 257, float(cnum))
    gamma[:3] = [0.0, -1e-13, 1e-13]          # the |γ| < 1e-12 guard
    want = jnb.fold_threshold(
        jnb.BNParams(*map(jnp.asarray, (mean, var, gamma, beta))), cnum,
        rounded=rounded)
    got = tnb.fold_threshold(
        tnb.BNParams(*map(torch.from_numpy, (mean, var, gamma, beta))), cnum,
        rounded=rounded)
    assert got.c.dtype == torch.float32 and got.flip.dtype == torch.bool
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))
    np.testing.assert_array_equal(got.flip.numpy(), np.asarray(want.flip))
    assert got.flip.any() and not got.flip.all()


def test_norm_binarize_and_norm_only_match_jax():
    rng = np.random.default_rng(7)
    k = 1024
    y_l = rng.integers(0, k + 1, (5, 64)).astype(np.int32)
    mean, var, gamma, beta = _bn(rng, 64, float(k))
    jbn = jnb.BNParams(*map(jnp.asarray, (mean, var, gamma, beta)))
    tbn = tnb.BNParams(*map(torch.from_numpy, (mean, var, gamma, beta)))
    np.testing.assert_array_equal(
        tnb.norm_only(torch.from_numpy(y_l), tbn, k).numpy(),
        np.asarray(jnb.norm_only(jnp.asarray(y_l), jbn, k)))
    thr_j = jnb.fold_threshold(jbn, k)
    thr_t = tnb.fold_threshold(tbn, k)
    np.testing.assert_array_equal(
        tnb.norm_binarize(torch.from_numpy(y_l), thr_t).numpy(),
        np.asarray(jnb.norm_binarize(jnp.asarray(y_l), thr_j)))
    # the folded comparator agrees with sign(BN) everywhere (eq. 8)
    z = tnb.norm_only(torch.from_numpy(y_l), tbn, k)
    np.testing.assert_array_equal(
        tnb.norm_binarize(torch.from_numpy(y_l), thr_t).numpy(),
        (z >= 0).numpy().astype(np.int8))


def test_quantizers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0, :] = [0.5, 15.5 / 62, 16.5 / 62]   # round-half-even cases
    w = rng.normal(0, 0.1, (16, 3, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tbin.quantize_input_6bit(torch.from_numpy(x)).numpy(),
        np.asarray(jbin.quantize_input_6bit(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tbin.quantize_weight_2bit(torch.from_numpy(w)).numpy(),
        np.asarray(jbin.quantize_weight_2bit(jnp.asarray(w))))
