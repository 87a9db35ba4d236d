"""The port's weight-only binary matmul (``kernels/ops.py::
binary_weight_matmul``, K6 on the card) on CPU tensors against the JAX
reference's ``kernels/ops.py::binary_weight_matmul``, which runs its
Pallas kernel in interpret mode here, as tests/test_xnor_lm.py runs it.

* ±1 activations: equal. Every product is ±1 and every partial sum an
  integer below 2**24, so both sides are exact whatever the order of
  their float32 sums.
* Real activations, float32 and bfloat16, with and without the scale α:
  allclose. Both round the activations to bf16 and multiply by ±1
  exactly; they differ only in the order of the float32 sums (the
  reference sums per 1024-element K-chunk on its MXU), a few ulps of the
  partial sums: rtol 1e-5 and atol 1e-5 at float32. A bfloat16 output
  rounds that float32 result once more, and a sum that lands on either
  side of a bf16 rounding boundary differs by one bf16 ulp: rtol 2**-7.
* Ragged K (padded with zero activations), ragged M and N, leading dims.
* Bad ``k`` / word counts raise; the CUDA wrapper refuses CPU tensors.

The K6 kernel itself cannot build here; ``chip_smoke.py`` holds it
against the same plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import bitpack
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import xnor_matmul as kmm

# (lead shape, k, n): the LM's decode and prefill shapes at the test
# config's width, ragged K / M / N, leading dims
SHAPES = [((4,), 128, 128), ((4,), 256, 128), ((16,), 128, 256),
          ((5,), 40, 33), ((2, 3), 70, 9), ((37,), 1100, 77)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


def _weights(rng, n, k):
    w = rng.normal(size=(n, k)).astype(np.float32)
    return bitpack.pack_pm1(torch.from_numpy(w))


def _ref(a_np, w_words, k, scale=None, dtype=jnp.float32):
    return np.asarray(jops.binary_weight_matmul(
        jnp.asarray(a_np, dtype), jnp.asarray(w_words.numpy()), k=k,
        scale=None if scale is None else jnp.asarray(scale)).astype(
            jnp.float32))


@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_pm1_activations_equal_reference(lead, k, n):
    rng = np.random.default_rng(k * 7 + n)
    a = rng.choice([-1.0, 1.0], (*lead, k)).astype(np.float32)
    w = _weights(rng, n, k)
    got = ops.binary_weight_matmul(torch.from_numpy(a), w, k=k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(got.numpy(), _ref(a, w, k))
    # and the plain version equals the ±1 dot of the unpacked weights
    w_pm1 = bitpack.decode_pm1(bitpack.unpack_bits(w, k)).numpy()
    np.testing.assert_array_equal(got.numpy(), a @ w_pm1.T)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,k,n", SHAPES[::2] + SHAPES[3:4])
def test_real_activations_allclose_reference(lead, k, n, dtype, scaled):
    rng = np.random.default_rng(k + n)
    a = rng.normal(size=(*lead, k)).astype(np.float32)
    w = _weights(rng, n, k)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32) if scaled else None
    t_dtype = getattr(torch, dtype)
    got = ops.binary_weight_matmul(
        torch.from_numpy(a).to(t_dtype), w, k=k,
        scale=None if scale is None else torch.from_numpy(scale))
    assert got.dtype == t_dtype
    want = _ref(a, w, k, scale, getattr(jnp, dtype))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               **TOL[dtype])


def test_plain_version_rounds_activations_to_bf16():
    """0.1 is not a bf16 value: the product uses bf16(0.1), as the
    reference's MXU does."""
    w = bitpack.pack_pm1(torch.ones((1, 32)))
    a = torch.full((1, 32), 0.1)
    got = ref.binary_weight_matmul_ref(a, w)
    assert got.item() == 32 * torch.tensor(0.1).to(torch.bfloat16).item()
    np.testing.assert_array_equal(got.numpy(), _ref(a.numpy(), w, 32))


def test_ops_reject_bad_k_and_word_count():
    a = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="disagrees"):
        ops.binary_weight_matmul(a, torch.zeros((3, 2), dtype=torch.int32),
                                 k=60)
    with pytest.raises(ValueError, match="packed weight words"):
        ops.binary_weight_matmul(a, torch.zeros((3, 3), dtype=torch.int32),
                                 k=64)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The K6 wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself, and a refused call counts no launch."""
    before = kmm.binary_weight_matmul.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmm.binary_weight_matmul(torch.zeros((4, 64)),
                                 torch.zeros((3, 2), dtype=torch.int32))
    assert kmm.binary_weight_matmul.launches == before
    assert "binary_weight_matmul" in _build.SIGNATURES
    assert (_build.CSRC / "binary_weight_matmul.cu").is_file()
