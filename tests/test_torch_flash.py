"""K7's plain version and its entry point on the CPU against the live JAX
reference (``repro/kernels/ops.py::flash_attention``, the Pallas kernel in
interpret mode as tests/test_kernels.py runs it, and
``repro/kernels/ref.py::flash_attention_ref``).

Inputs are numpy arrays from fixed seeds, handed to both packages.
Tolerances:

* float32: rtol = atol = 1e-5. Both sides compute float32 scores and
  softmax; they differ in the order of the sums (the Pallas kernel walks
  128-key blocks with an online softmax) and in where the scale is
  applied.
* bfloat16: rtol = atol = 2e-2 (``kernels/ref.py`` and the kernels round
  the attention weights to bf16 at different points: p / l in the plain
  version, the unnormalised p in the kernels, a relative 2**-9 on every
  weight, which shows as an absolute error at the scale of v), and at
  most 0.5 % of the elements off by more than one bf16 ulp of
  max(|reference|, 0.25). ``chip_smoke.py`` holds K7 to the same bounds.
* Against the reference's own oracle, which is the same algorithm, the
  port's plain version is held at the float32 tolerance (the einsums sum
  over hd and S in another order); in bfloat16 at the bf16 tolerance with
  at most 0.1 % of the elements not bitwise equal (the two einsums round
  their bf16 sums apart now and then; 0.02 % measured).

The CUDA kernel itself runs only on the card (``chip_smoke.py``); here
its wrapper must refuse CPU tensors and its launch counter stays 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ULP_FLOOR, ULP_SHARE = 0.25, 0.005
# tests/test_kernels.py's shapes (b, hq, hkv, s, hd)
SHAPES = [(1, 2, 2, 256, 64), (2, 4, 2, 256, 64), (1, 8, 2, 512, 128),
          (1, 2, 1, 384, 64)]


def _inputs(b, hq, hkv, s, hd, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, hd)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    if dtype == "bfloat16":      # round once so both sides see equal inputs
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _both(arrs, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _ulp_share(got: np.ndarray, want: np.ndarray) -> float:
    mag = np.maximum(np.abs(want), ULP_FLOOR)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.mean(np.abs(got - want) > ulp))


def _check(got: torch.Tensor, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert _ulp_share(got, want) <= ULP_SHARE


@pytest.mark.parametrize("b,hq,hkv,s,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(b, hq, hkv, s, hd, causal, dtype):
    arrs = _inputs(b, hq, hkv, s, hd, seed=hash((b, hq, s, causal)) % 2**31,
                   dtype=dtype)
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_block=128,
                                kv_block=128)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("b,hq,hkv,s,hd,causal", [
    (1, 2, 1, 200, 64, False),          # ragged, non-causal
    (1, 2, 1, 200, 64, True),
    (1, 32, 8, 70, 128, True),          # the dense LM's head layout
    (2, 4, 2, 33, 16, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(b, hq, hkv, s, hd, causal, dtype):
    """The ragged non-causal case is checked against the oracle, not the
    reference's wrapper: that wrapper pads S up to its block grid and
    masks keys only at the padded length, so with ``causal=False`` the
    zero pad keys join its softmax (0.08 off at this shape). The port
    masks keys at the true S, as the oracle does (ROADMAP §3)."""
    arrs = _inputs(b, hq, hkv, s, hd, seed=s + hd, dtype=dtype)
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                      np.float32)
    got = ops.flash_attention(q, k, v, causal=causal).to(torch.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
        assert np.mean(got.numpy() != want) <= 1e-3


@pytest.mark.parametrize("bad", ["ndim", "groups", "kv_shape", "dtype_mix",
                                 "float16", "head_dim"])
def test_entry_point_checks_raise(bad):
    q, k, v = (torch.zeros((1, h, 8, 16)) for h in (4, 2, 2))
    if bad == "ndim":
        q = q[0]
    elif bad == "groups":
        k, v = (torch.zeros((1, 3, 8, 16)) for _ in range(2))
    elif bad == "kv_shape":
        v = torch.zeros((1, 2, 9, 16))
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "float16":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    else:
        q, k, v = (torch.zeros((1, h, 8, 272)) for h in (4, 2, 2))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.zeros((1, h, 8, 16)) for h in (4, 2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfa.flash_attention(q, k, v)
    assert kfa.flash_attention.launches == 0


def test_cpu_tensors_never_launch_k7():
    """A CPU tensor runs the plain version: the launch counter stays 0,
    through the entry point and through a whole prefill."""
    from repro_torch import configs
    from repro_torch.models import transformer
    kfa.flash_attention.launches = 0
    arrs = _inputs(1, 4, 2, 40, 16, seed=3)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    cfg = configs.get_config("qwen3-8b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    transformer.prefill(cfg, params, torch.zeros((1, 9), dtype=torch.int64))
    assert kfa.flash_attention.launches == 0
