"""The port's kernel entry points (``repro_torch/kernels/ops.py``) on CPU
tensors against the JAX reference's ``kernels/ops.py`` on every path:
"vpu" and "mxu" run the Pallas kernels in interpret mode, as
tests/test_kernels.py and tests/test_xnor_conv.py run them, and "xla"
runs the reference's plain version. On a CPU tensor the port runs its
plain version for every path. Integer agree-counts and bits are held to
exact equality, on small ragged shapes, stride 1 and 2, with and without
the fused threshold epilogue.

The CUDA kernels themselves (K1-K4) cannot build or run here; they are
held against the same plain versions on the card by ``chip_smoke.py``.
What is tested here is that their wrappers refuse CPU tensors and that a
build without a CUDA compiler raises. The fused pair (K5) is tested the
same way in tests/test_torch_fused.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import xnor_conv as jconv
from repro_torch.core import bitpack
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_matmul as kmm

PATHS = ["vpu", "mxu", "xla"]
# (lead shape, k, n): ragged k and n, a leading batch of 2 dims
MATMUL = [((5,), 70, 9), ((2, 3), 33, 16), ((8,), 100, 33)]
# (h, w, c, o, f, stride, pad)
CONV = [(7, 9, 32, 8, 3, 1, 1), (9, 9, 32, 8, 3, 2, 1),
        (8, 8, 48, 8, 3, 1, 1), (10, 6, 64, 12, 5, 2, 2)]


def _thresholds(rng, n, k):
    return (rng.integers(0, k + 1, (n,)).astype(np.float32),
            rng.integers(0, 2, (n,)).astype(bool))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lead,k,n", MATMUL)
@pytest.mark.parametrize("path", PATHS)
def test_xnor_matmul_matches_jax(path, lead, k, n, fused):
    rng = np.random.default_rng(k * 100 + n)
    a = bitpack.pack_pm1(torch.from_numpy(rng.normal(size=(*lead, k))))
    w = bitpack.pack_pm1(torch.from_numpy(rng.normal(size=(n, k))))
    thr = {}
    jthr = {}
    if fused:
        c, f = _thresholds(rng, n, k)
        thr = dict(thr_c=torch.from_numpy(c), thr_flip=torch.from_numpy(f))
        jthr = dict(thr_c=jnp.asarray(c), thr_flip=jnp.asarray(f))
    want = np.asarray(jops.xnor_matmul(jnp.asarray(a.numpy()),
                                       jnp.asarray(w.numpy()), k=k,
                                       path=path, **jthr))
    got = ops.xnor_matmul(a, w, k=k, path=path, **thr)
    assert got.dtype == (torch.int8 if fused else torch.int32)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("h,w,c,o,f,stride,pad", CONV)
@pytest.mark.parametrize("path", PATHS)
def test_xnor_conv2d_matches_jax(path, h, w, c, o, f, stride, pad, fused):
    rng = np.random.default_rng(h * 1000 + c + stride)
    a_bits = rng.integers(0, 2, (2, h, w, c)).astype(np.int8)
    w_pm1 = rng.choice([-1.0, 1.0], (o, f, f, c)).astype(np.float32)
    w_words = kconv.pack_conv_weights(torch.from_numpy(w_pm1))
    np.testing.assert_array_equal(
        w_words.numpy(),
        np.asarray(jconv.pack_conv_weights(jnp.asarray(w_pm1))))
    k = f * f * c
    thr, jthr = {}, {}
    if fused:
        cc, ff = _thresholds(rng, o, k)
        thr = dict(thr_c=torch.from_numpy(cc), thr_flip=torch.from_numpy(ff))
        jthr = dict(thr_c=jnp.asarray(cc), thr_flip=jnp.asarray(ff))
    want = np.asarray(jops.xnor_conv2d(
        jnp.asarray(a_bits), jnp.asarray(w_words.numpy()), k=k, fh=f, fw=f,
        stride=stride, pad=pad, path=path, **jthr))
    got = ops.xnor_conv2d(torch.from_numpy(a_bits), w_words, k=k, fh=f,
                          fw=f, stride=stride, pad=pad, path=path, **thr)
    assert got.dtype == (torch.int8 if fused else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_ref_matches_im2col_matmul_ref():
    """The two plain versions agree on a 32-aligned conv (same packed
    words in both weight layouts), as the two dataflows must."""
    rng = np.random.default_rng(11)
    a_bits = torch.from_numpy(rng.integers(0, 2, (2, 6, 6, 64)).astype(np.int8))
    w_bits = torch.from_numpy(rng.integers(0, 2, (8, 3, 3, 64)).astype(np.int8))
    y = ref.xnor_conv2d_ref(a_bits, w_bits, stride=1, pad=1)
    from repro_torch.core.bconv import _im2col
    patches = bitpack.pack_bits(_im2col(a_bits, 3, 3))
    y2 = ref.xnor_matmul_ref(patches.reshape(-1, 18),
                             bitpack.pack_bits(w_bits.reshape(8, -1)), 576)
    np.testing.assert_array_equal(y.numpy(), y2.reshape(2, 6, 6, 8).numpy())


def test_ops_reject_bad_arguments():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="word-count"):
        ops.xnor_matmul(a, torch.zeros((3, 3), dtype=torch.int32), k=64)
    with pytest.raises(ValueError, match="packed int32 words"):
        ops.xnor_matmul(a, torch.zeros((3, 2), dtype=torch.int32), k=30)
    with pytest.raises(ValueError, match="unknown kernel path"):
        ops.xnor_matmul(a, torch.zeros((3, 2), dtype=torch.int32), k=64,
                        path="tpu")


@pytest.mark.parametrize("fn", [kmm.xnor_matmul_vpu, kmm.xnor_matmul_mxu])
def test_matmul_kernel_wrappers_refuse_cpu_tensors(fn):
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself, and a refused call counts no launch."""
    before = fn.launches
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(a, a, k=64)
    assert fn.launches == before


@pytest.mark.parametrize("fn", [kconv.xnor_conv2d_vpu, kconv.xnor_conv2d_mxu])
def test_conv_kernel_wrappers_refuse_cpu_tensors(fn):
    before = fn.launches
    a = torch.zeros((1, 4, 4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(a, torch.zeros((2, 9), dtype=torch.int32), k=288, fh=3, fw=3)
    assert fn.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert set(_build.SIGNATURES) == {"xnor_matmul_vpu", "xnor_matmul_mxu",
                                      "xnor_conv2d_vpu", "xnor_conv2d_mxu",
                                      "xnor_conv2d_pair_vpu",
                                      "xnor_conv2d_pair_mxu",
                                      "binary_weight_matmul",
                                      "flash_attention",
                                      "flash_attention_tc"}
    assert set(_build.PROBES) == {"mma_rate_probe",
                                  "flash_attention_simt_plan"}
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "xnor_matmul.cu", "xnor_conv.cu", "xnor_conv_fused.cu",
        "binary_weight_matmul.cu", "flash_attention.cu",
        "flash_attention_tc.cu", "mma_probe.cu"}
