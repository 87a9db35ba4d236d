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

K7 takes values narrower than the queries and keys (MLA: q and k at 192,
v at 128); its output then has v's width, and equals the padded call's
first columns. It has two CUDA variants, chosen by
``kernels/flash_attention.py::pick_variant`` from (dtype, hd, dv): "tc"
(``csrc/flash_attention_tc.cu``, the tensor cores, bf16 at (hd, dv) =
(64, 64), (128, 128), (192, 128)) and "simt" (``csrc/flash_attention.cu``,
the CUDA cores, everything else). "tc" changes the order of the
arithmetic in two ways: the scale multiplies the float32 QK^T
accumulator instead of q before the product, and the softmax runs in
base 2, exp2 with log2(e) folded into the scale (c = scale * log2(e),
m = max(s) * c, p = exp2(fma(s, c, -m))). A plain emulation of that order
(``_tc_emulation``, in this file and not in the package: key tiles of the
kernel's TC_BN, p rounded to bf16 before the PV product, l summing the
float32 p)
agrees with the Pallas kernel at the bf16 tolerance above (at (192, 128)
against the kernel on v zero-padded to 192, first 128 columns), which
shows the reordering stays inside the contract's tolerance.

The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here the wrapper must refuse CPU tensors, its launch counters stay 0, and
the pure parts of the dispatch (``pick_variant``, ``tma_ready``, the
"tc" block's shared memory recounted from the CUDA source) are checked.
"""
import re
from pathlib import Path

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
# MLA's head widths at DeepSeek-V2's sizes: q and k at qk_nope + qk_rope =
# 192, v at v_head_dim = 128 (hd given as the pair (hd, dv))
MLA_SHAPE = pytest.param(1, 2, 2, 256, (192, 128), id="1-2-2-256-192-128")


def _widths(hd) -> tuple[int, int]:
    """(q/k width, v width) of a shape's hd: an int, or a pair."""
    return tuple(hd) if isinstance(hd, tuple) else (hd, hd)


def _inputs(b, hq, hkv, s, hd, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    hd, dv = _widths(hd)
    arrs = [rng.standard_normal((b, h, s, w)).astype(np.float32)
            for h, w in ((hq, hd), (hkv, hd), (hkv, dv))]
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
                                 "float16", "head_dim", "v_wider",
                                 "v_heads", "v_batch"])
def test_entry_point_checks_raise(bad):
    q, k, v = (torch.zeros((1, h, 8, 16)) for h in (4, 2, 2))
    if bad == "ndim":
        q = q[0]
    elif bad == "groups":
        k, v = (torch.zeros((1, 3, 8, 16)) for _ in range(2))
    elif bad == "kv_shape":
        v = torch.zeros((1, 2, 9, 16))
    elif bad == "v_wider":          # dv > hd
        v = torch.zeros((1, 2, 8, 24))
    elif bad == "v_heads":          # narrower v, other dims unlike k's
        v = torch.zeros((1, 1, 8, 8))
    elif bad == "v_batch":
        v = torch.zeros((2, 2, 8, 8))
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
    assert kfa.flash_attention.launches_tc == 0
    assert kfa.flash_attention.launches_simt == 0


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 96, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 256, "simt"), (torch.bfloat16, 1, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 96, "simt"), (torch.float32, 256, "simt"),
    pytest.param(torch.bfloat16, (192, 128), "tc", id="bf16-192-128-tc"),
    pytest.param(torch.bfloat16, (192, 192), "simt",
                 id="bf16-192-192-simt"),
    pytest.param(torch.float32, (192, 128), "simt", id="f32-192-128-simt"),
    pytest.param(torch.bfloat16, (128, 64), "simt", id="bf16-128-64-simt"),
])
def test_pick_variant(dtype, hd, want):
    """bf16 at (hd, dv) = (64, 64), (128, 128) and (192, 128) goes to the
    tensor cores; float32 at any widths and bf16 at any others to the CUDA
    cores. hd alone means dv = hd."""
    if isinstance(hd, tuple):
        assert kfa.pick_variant(dtype, *hd) == want
    else:
        assert kfa.pick_variant(dtype, hd) == want
        assert kfa.pick_variant(dtype, hd, hd) == want


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64),
                                      (torch.bfloat16, 0),
                                      (torch.bfloat16, 257),
                                      (torch.float32, 512),
                                      (torch.bfloat16, (128, 192)),
                                      (torch.bfloat16, (192, 0))])
def test_pick_variant_raises_outside_contract(dtype, hd):
    with pytest.raises(ValueError):
        kfa.pick_variant(dtype, *_widths(hd))


def _tc_source() -> str:
    return (Path(kfa.__file__).parent / "csrc" /
            "flash_attention_tc.cu").read_text()


def _tc_constants() -> dict:
    src = _tc_source()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("TC_BM", "TC_BN", "TC_MAX_STAGES", "TC_SMEM_LIMIT")}


@pytest.mark.parametrize("hd,hd_v", [
    pytest.param(64, 64, id="64"), pytest.param(128, 128, id="128"),
    pytest.param(192, 128, id="192-128")])
def test_tc_shared_memory_fits(hd, hd_v):
    """The "tc" block's shared memory, counted here from the tile
    constants of the CUDA source, fits the H100's 227 KB per block at
    every "tc" shape, at the ring depth the source pins for it (its
    ``static_assert`` on ``tc_stages``): 3 stages and 115,816 bytes at
    64 / 64, 3 and 230,504 at 128 / 128, 2 and 214,088 at 192 / 128,
    where 3 would take 295,992. The source's list of instantiations
    (``TC_SHAPES``) is the wrapper's."""
    src = _tc_source()
    listed = re.search(r"#define TC_SHAPES\(X\) (.*)", src).group(1)
    assert tuple((int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", listed)) == kfa.TC_SHAPES
    assert (hd, hd_v) in kfa.TC_SHAPES
    c = _tc_constants()
    assert (c["TC_BM"], c["TC_BN"], c["TC_SMEM_LIMIT"]) == (
        kfa.TC_BM, kfa.TC_BN, kfa.SMEM_PER_BLOCK)
    pinned = {(int(a), int(b)): int(n) for a, b, n in re.findall(
        r"tc_stages\((\d+), (\d+)\) == (\d+)", src)}
    assert set(pinned) == set(kfa.TC_SHAPES)

    def smem(stages: int) -> int:
        # alignment slack, the Q tile, the K/V ring, 1 + 4 x stages
        # mbarriers (tc_smem_bytes in the source)
        return (1024 + c["TC_BM"] * hd * 2
                + stages * c["TC_BN"] * (hd + hd_v) * 2
                + 8 * (1 + 4 * stages))

    stages = pinned[hd, hd_v]
    want = {(64, 64): (3, 115816), (128, 128): (3, 230504),
            (192, 128): (2, 214088)}[hd, hd_v]
    assert (stages, smem(stages)) == want
    assert smem(stages) <= c["TC_SMEM_LIMIT"]
    # the deepest ring that fits, up to TC_MAX_STAGES
    assert stages == c["TC_MAX_STAGES"] or smem(stages + 1) > c[
        "TC_SMEM_LIMIT"]


def test_tma_ready():
    """Contiguous tensors and head-major views of (B, S, H, hd) tensors are
    read in place; a strided last dimension, a row stride that is not a
    multiple of 8 elements or a misaligned start is not."""
    x = torch.zeros((2, 40, 4, 64), dtype=torch.bfloat16)
    assert kfa.tma_ready(x.transpose(1, 2))
    assert kfa.tma_ready(x.transpose(1, 2).contiguous())
    assert kfa.tma_ready(torch.zeros((1, 1, 1, 64))[:, :, :1])
    assert not kfa.tma_ready(x.transpose(1, 3))
    assert not kfa.tma_ready(torch.zeros((1, 2, 5, 12)))
    flat = torch.zeros(1 + 2 * 5 * 64, dtype=torch.bfloat16)
    assert not kfa.tma_ready(flat[1:].view(1, 2, 5, 64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_entry_point_takes_strided_views(dtype, causal):
    """``ops.flash_attention`` on head-major views of (B, S, H, hd)
    tensors, as ``models/attention.py::gqa_forward`` hands them over,
    equals it on contiguous copies. Here that is the entry point's
    contract through its CPU route (the plain version); the "tc" kernel's
    reading of such views is held against the plain version on the card
    (``chip_smoke.py``)."""
    b, s, hq, hkv, hd = 2, 70, 8, 2, 64
    rng = np.random.default_rng(11)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd))
                                .astype(np.float32)).to(tdt)
               for h in (hq, hkv, hkv))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views, causal=causal)
    want = ops.flash_attention(*(t.contiguous() for t in views),
                               causal=causal)
    assert got.shape == (b, hq, s, hd)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 (nearest even), back in float32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _tc_emulation(q, k, v, causal: bool,
                  tile: int = kfa.TC_BN) -> np.ndarray:
    """K7 tc's order of arithmetic in plain numpy (float32 arrays holding
    bf16 values, (B, Hq, S, hd), (B, Hkv, S, hd) and v (B, Hkv, S, dv)):
    per tile of keys the
    float32 scores s = q k^T, masked keys -inf; with c = scale * log2(e)
    (float32), the running max m = max(m_old, max(s) * c), corr =
    exp2(m_old - m), p = exp2(fma(s, c, -m)) (the fma in float64, rounded
    once to float32), l = l corr + sum(p) over the float32 p, acc = acc
    corr + bf16(p) v; out = bf16(acc / max(l, 1e-30))."""
    b, hq, s, hd = q.shape
    dv = v.shape[3]
    group = hq // k.shape[1]
    scale = np.float32(np.float64(np.float32(hd ** -0.5)) * np.log2(np.e))
    rows = np.arange(s)[:, None]
    out = np.empty((b, hq, s, dv), np.float32)
    for bi in range(b):
        for h in range(hq):
            qh, kh, vh = q[bi, h], k[bi, h // group], v[bi, h // group]
            m = np.full((s,), -np.inf, np.float32)
            l = np.zeros((s,), np.float32)
            acc = np.zeros((s, dv), np.float32)
            for k0 in range(0, s, tile):
                cols = np.arange(k0, min(k0 + tile, s))[None, :]
                sc = qh @ kh[k0:k0 + tile].T
                if causal:
                    sc = np.where(cols <= rows, sc, -np.inf)
                mn = np.maximum(m, sc.max(axis=1) * scale)
                corr = np.exp2(m - mn)
                p = np.exp2((sc.astype(np.float64) * np.float64(scale)
                             - mn[:, None]).astype(np.float32))
                l = l * corr + p.sum(axis=1, dtype=np.float32)
                acc = acc * corr[:, None] + _bf16(p) @ vh[k0:k0 + tile]
                m = mn
            out[bi, h] = _bf16(acc / np.maximum(l, np.float32(1e-30))[:, None])
    return out


@pytest.mark.parametrize("b,hq,hkv,s,hd", SHAPES + [MLA_SHAPE])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_order_of_arithmetic_matches_reference_kernel(b, hq, hkv, s, hd,
                                                          causal):
    """(d): the tensor-core variant's reordering (scale after the product,
    exp2 with log2 e folded in, p rounded to bf16, l from the float32 p)
    agrees with the Pallas kernel in interpret mode at BF16_TOL with at
    most 0.5 % of the elements beyond one bf16 ulp, and with the port's
    plain version at the same bound. At MLA's widths the Pallas kernel,
    which takes one width, runs on v zero-padded to q's, and its first dv
    columns are compared."""
    hd, dv = _widths(hd)
    assert kfa.pick_variant(torch.bfloat16, hd, dv) == "tc"
    arrs = _inputs(b, hq, hkv, s, (hd, dv), seed=7 * s + hd + causal,
                   dtype="bfloat16")
    (jq, jk, jv), (q, k, v) = _both(arrs, "bfloat16")
    got = torch.from_numpy(_tc_emulation(*arrs, causal=causal))
    assert got.shape == (b, hq, s, dv)
    jv = jnp.pad(jv, ((0, 0), (0, 0), (0, 0), (0, hd - dv)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_block=128,
                                kv_block=128)[..., :dv]
    _check(got, want, "bfloat16")
    _check(got, ops.flash_attention(q, k, v, causal=causal).float().numpy(),
           "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_narrow_v_equals_padded_call(dtype, causal):
    """v at dv = 128 under q and k at 192 (MLA's widths): the plain
    version's output is (B, Hq, S, 128) and equals, bit for bit, the first
    128 columns of the call on v zero-padded to 192 (each output column
    sums its own column of v; the zero columns add nothing). The "simt"
    wrapper pads v so and slices the same columns on the card."""
    b, hq, hkv, s = 1, 4, 2, 70
    arrs = _inputs(b, hq, hkv, s, (192, 128), seed=5 + causal, dtype=dtype)
    _, (q, k, v) = _both(arrs, dtype)
    kfa.check_inputs(q, k, v)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (b, hq, s, 128) and got.dtype == q.dtype
    padded = ops.flash_attention(
        q, k, torch.nn.functional.pad(v, (0, 64)), causal=causal)
    assert padded.shape == (b, hq, s, 192)
    assert not bool(padded[..., 128:].any())
    torch.testing.assert_close(got, padded[..., :128], rtol=0, atol=0)


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
