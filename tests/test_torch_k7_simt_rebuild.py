"""K7 "simt", the CUDA-core flash attention, as rebuilt for Hopper.

``csrc/flash_attention.cu::flash_simt_kernel``: a block of 4 warps per
(batch * head, 64-row query tile); hd a template constant per bucket
(64, 96, 112, 128, 192, 256); warp w owns rows 16w .. 16w + 15, a lane a
4-row x TK/8-key register tile of scores and 4 rows x hd/8 columns of the
output; K/V tiles of TK keys (64 where two blocks of 64 keys fit an SM,
else 32) through a 2-stage cp.async ring; the online softmax in
registers. The kernel builds and runs only on the card, where
``chip_smoke.py`` holds it against ``kernels/ref.py``. Tested here:

(a) a numpy emulation of the kernel's order of arithmetic (q scaled in
    float32 before the product, float32 scores per tile of the bucket's
    TK keys, a masked score of -1e30, the per-tile rescale of l and the
    output, p rounded to bf16 before the PV product while l sums the
    float32 p, out = acc / max(l, 1e-30)) against the Pallas kernel in
    interpret mode on padded shapes (``repro/kernels/ops.py::
    flash_attention``, as tests/test_torch_flash.py runs it), against the
    reference's oracle (``repro/kernels/ref.py::flash_attention_ref``) and
    against the port's plain version, at every hd bucket, causal and not.
    Ragged non-causal shapes go against the oracles only: the reference's
    wrapper pads S and masks keys at the padded length (ROADMAP §3).
    Tolerances: float32 rtol = atol = 1e-5 (the order of the sums);
    bf16 rtol = atol = 2e-2 with at most 0.5% of the elements beyond one
    bf16 ulp of max(|reference|, 0.25) (p is rounded unnormalised here, as
    p / l in the plain version and the reference).
(b) the shared-memory mirror ``kernels/flash_attention.py::
    simt_smem_bytes`` and ``simt_kv_tile`` against the .cu's constants:
    every bucket fits 232,448 bytes a block, and at hd <= 128 in float32
    two blocks fit an SM's 233,472 bytes with 1 KB reserved each.
(c) the wrapper's operands (``simt_operands``): contiguous, 16-byte
    aligned, hd padded with zero columns to whole 16-byte units, which
    leave the emulated result unchanged.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ULP_FLOOR, ULP_SHARE = 0.25, 0.005
NEG_INF = np.float32(-1e30)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 (nearest even), back in float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(b, hq, hkv, s, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, hd)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    return [_bf16(a) for a in arrs] if dtype == "bfloat16" else arrs


def simt_emulation(q, k, v, causal: bool, dtype: str,
                   scale: float | None = None) -> np.ndarray:
    """K7 simt's order of arithmetic in plain numpy (float32 arrays, bf16
    values where ``dtype`` is bfloat16): q * scale (default hd**-0.5) in
    float32, then per
    tile of ``simt_kv_tile`` keys the float32 scores, masked keys -1e30,
    m = max(m_old, max(s)), corr = exp(m_old - m), p = exp(s - m),
    l = l corr + sum(p) over the float32 p, acc = acc corr + round(p) v
    with p rounded to v's dtype; out = acc / max(l, 1e-30) in q's dtype.
    A tile wholly above a row's diagonal (which the kernel's warp skips)
    leaves m, l and acc exactly as they were."""
    b, hq, s, hd = q.shape
    group = hq // k.shape[1]
    tk = kfa.simt_kv_tile(hd, DTYPES[dtype])
    scale = np.float32(hd ** -0.5 if scale is None else scale)
    rnd = _bf16 if dtype == "bfloat16" else (lambda x: x)
    rows = np.arange(s)[:, None]
    out = np.empty_like(q)
    for bi in range(b):
        for h in range(hq):
            qh = (q[bi, h] * scale).astype(np.float32)
            kh, vh = k[bi, h // group], v[bi, h // group]
            m = np.full((s,), NEG_INF, np.float32)
            l = np.zeros((s,), np.float32)
            acc = np.zeros((s, hd), np.float32)
            for k0 in range(0, s, tk):
                cols = np.arange(k0, min(k0 + tk, s))[None, :]
                sc = qh @ kh[k0:k0 + tk].T
                if causal:
                    sc = np.where(cols <= rows, sc, NEG_INF)
                mn = np.maximum(m, sc.max(axis=1))
                corr = np.exp(m - mn)
                p = np.exp(sc - mn[:, None])
                l = l * corr + p.sum(axis=1, dtype=np.float32)
                acc = acc * corr[:, None] + rnd(p) @ vh[k0:k0 + tk]
                m = mn
            out[bi, h] = rnd(acc / np.maximum(l, np.float32(1e-30))[:, None])
    return out


def _ulp_share(got: np.ndarray, want: np.ndarray) -> float:
    mag = np.maximum(np.abs(want), ULP_FLOOR)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.mean(np.abs(got - want) > ulp))


def _check(got: np.ndarray, want, dtype: str):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert _ulp_share(got, want) <= ULP_SHARE


def _oracles(arrs, causal, dtype):
    """The reference's oracle (jnp) and the port's plain version."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(DTYPES[dtype]) for a in arrs)
    return (jref.flash_attention_ref(jq, jk, jv, causal=causal),
            ref.flash_attention_ref(q, k, v, causal=causal).float().numpy())


@pytest.mark.parametrize("hd", kfa.SIMT_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_reference_kernel(hd, causal, dtype):
    """(a) on a padded shape (S a multiple of the Pallas kernel's 128-row
    blocks, several of the emulation's TK-key tiles): the Pallas kernel in
    interpret mode, the reference's oracle and the port's plain version."""
    b, hq, hkv, s = 1, 2, 1, 256
    arrs = _inputs(b, hq, hkv, s, hd, seed=13 * hd + causal, dtype=dtype)
    got = simt_emulation(*arrs, causal=causal, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    _check(got, jops.flash_attention(jq, jk, jv, causal=causal, q_block=128,
                                     kv_block=128), dtype)
    for want in _oracles(arrs, causal, dtype):
        _check(got, want, dtype)


@pytest.mark.parametrize("b,hq,hkv,hd,s,causal", [
    (1, 4, 2, 112, 300, True),       # chip_smoke.py's bf16 rows
    (1, 4, 2, 192, 300, True),
    (1, 2, 1, 256, 200, False),      # ... and its float32 hd 256 row
    (2, 4, 2, 96, 77, False),
    (1, 2, 2, 33, 65, True),         # an hd below the smallest bucket
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_oracles_ragged(b, hq, hkv, hd, s, causal, dtype):
    """(a) on ragged S (a last tile past S, non-causal too) and an hd that
    runs in a larger bucket: the oracles only."""
    arrs = _inputs(b, hq, hkv, s, hd, seed=s + hd, dtype=dtype)
    got = simt_emulation(*arrs, causal=causal, dtype=dtype)
    for want in _oracles(arrs, causal, dtype):
        _check(got, want, dtype)


def _cu() -> str:
    return (_build.CSRC / "flash_attention.cu").read_text()


def test_mirror_constants_match_the_source():
    """The Python mirror reads what the launcher compiles: tile rows, ring
    depth, p padding, the SM's shared memory and its reservation, and the
    hd buckets of ``by_bucket``."""
    src = _cu()
    const = {n: int(v) for n, v in re.findall(
        r"constexpr (?:int|size_t) (FA_\w+) = (\d+);", src)}
    assert const["FA_TQ"] == kfa.SIMT_TQ
    assert const["FA_STAGES"] == kfa.SIMT_STAGES
    assert const["FA_PPAD"] == kfa.SIMT_PPAD
    assert const["FA_SMEM_SM"] == kfa.SMEM_PER_SM
    assert const["FA_SMEM_RESERVED"] == kfa.SMEM_RESERVED
    body = src[src.index("int by_bucket("):]
    body = body[:body.index("\n}\n")]
    limits = [int(x) for x in re.findall(r"hd <= (\d+)\) return F<T, \1>",
                                         body)]
    last = re.findall(r"\n  return F<T, (\d+)>", body)
    assert tuple(limits + [int(x) for x in last]) == kfa.SIMT_HEAD_DIMS


@pytest.mark.parametrize("hd", kfa.SIMT_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simt_shared_memory_fits(hd, dtype):
    """(b) every bucket fits the H100's 227 KB a block; in float32 at
    hd <= 128 two blocks fit an SM (1 KB reserved each)."""
    n = kfa.simt_smem_bytes(hd, dtype)
    assert n <= kfa.SMEM_PER_BLOCK
    if dtype == torch.float32 and hd <= 128:
        assert 2 * (n + kfa.SMEM_RESERVED) <= kfa.SMEM_PER_SM


@pytest.mark.parametrize("hd,bucket", [(1, 64), (33, 64), (64, 64), (65, 96),
                                       (96, 96), (100, 112), (112, 112),
                                       (120, 128), (128, 128), (129, 192),
                                       (192, 192), (200, 256), (256, 256)])
def test_simt_bucket(hd, bucket):
    """A hd runs at the least bucket that holds it."""
    assert kfa.simt_bucket(hd) == bucket
    assert kfa.simt_smem_bytes(hd, torch.float32) == kfa.simt_smem_bytes(
        bucket, torch.float32)


@pytest.mark.parametrize("hd,padded", [(33, {"float32": 36, "bfloat16": 40}),
                                       (36, {"float32": 36, "bfloat16": 40}),
                                       (40, {"float32": 40, "bfloat16": 40}),
                                       (112, {"float32": 112,
                                              "bfloat16": 112})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simt_operands_pad_rows_to_16_bytes(hd, padded, dtype):
    """(c) q, k and v come out contiguous and 16-byte aligned, hd padded
    with zero columns to whole 16-byte units (never past its bucket); an
    operand that already is so is handed over as it is."""
    dt = DTYPES[dtype]
    q = torch.randn(2, 5, 4, hd).to(dt).transpose(1, 2)     # a strided view
    k = torch.randn(2 * 5 * hd + 1).to(dt)[1:].view(2, 1, 5, hd)  # shifted
    v = torch.randn(2, 1, 5, hd).to(dt)
    out = kfa.simt_operands(q, k, v)
    for src, t in zip((q, k, v), out):
        assert t.shape == (*src.shape[:3], padded[dtype])
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert (t.shape[3] * t.element_size()) % 16 == 0
        assert kfa.simt_bucket(t.shape[3]) == kfa.simt_bucket(hd)
        assert torch.equal(t[..., :hd], src)
        assert not t[..., hd:].any()
    if padded[dtype] == hd:
        assert out[2] is v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_columns_change_nothing(dtype):
    """(c) the emulation on ``simt_operands``' zero-padded rows, with the
    unpadded hd's scale, gives the unpadded result in its first hd
    columns and zeros past them."""
    b, hq, hkv, hd, s = 1, 4, 2, 33, 70
    arrs = _inputs(b, hq, hkv, s, hd, seed=hd, dtype=dtype)
    padded = [t.float().numpy() for t in kfa.simt_operands(
        *(torch.from_numpy(a).to(DTYPES[dtype]) for a in arrs))]
    got = simt_emulation(*padded, causal=True, dtype=dtype,
                         scale=hd ** -0.5)
    want = simt_emulation(*arrs, causal=True, dtype=dtype)
    _check(got[..., :hd], want, dtype)
    assert not got[..., hd:].any()

