"""K2 and K4, the "mxu" binary matmul and conv of the port, as rebuilt for
Hopper (``csrc/xnor_matmul.cu``, ``csrc/xnor_conv.cu``): output channels
on the rows of ``mma.sync m16n8k256 .b1 .and.popc``, products on the
packed words, y = 32·Kw − popc(a) − popc(w) + 2·popc(a AND w) − n_pad,
K split over warps (and, for K2, over a thread-block cluster) where tiles
are too few for a wave of blocks.

The kernels build and run only on the card, where ``chip_smoke.py``
holds them bit-exact against ``kernels/ref.py``. Tested here:

* the Python mirrors of the launchers' plans (``xnor_matmul.py::
  mxu_plan``, ``xnor_conv.py::mxu_plan``) at every K1–K4 case of
  ``chip_smoke.py`` and over a seeded sweep: shared memory within the
  H100's 232,448 bytes per block, clusters of at most 8, a split of K
  that covers every word exactly once, a full wave at the path shapes;
  and the mirrors' constants against the ``.cu`` sources;
* a torch emulation of each kernel's order of arithmetic (8-word MMA
  steps, pad words zero in both operands, per-split partial sums with
  the and.popc correction, the constant from the true Kw or L), bit for
  bit against the JAX package's ``xnor_matmul_mxu`` and ``xnor_conv2d_mxu``
  run in interpret mode on the same numpy inputs.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import bitpack
from repro_torch.kernels import _build, mma_probe, ref
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_matmul as kmm

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# (M, N, Kw) of every K1/K2 launch chip_smoke.py makes
MM_CASES = sorted(
    {(CS.N_SLOTS, n, bitpack.packed_len(k)) for n, k, _ in CS.FC_SHAPES}
    | {(m, n, bitpack.packed_len(k)) for m, n, k, _ in CS.MM_EXTRAS}
    | {(CS.N_SLOTS * h * h, o, bitpack.packed_len(9 * c))
       for h, c, o in CS.CONV_SHAPES}
    | {(m, n, bitpack.packed_len(k)) for m in (CS.N_SLOTS, 16)
       for k, n in CS.BW_CALLS})
# (N, Ho, Wo, Cw, O, f, stride) of every K3/K4 launch
CONV_CASES = sorted(
    {(CS.N_SLOTS, h, h, c // 32, o, 3, 1) for h, c, o in CS.CONV_SHAPES}
    | {(n, (h + 2 * p - f) // s + 1, (w + 2 * p - f) // s + 1,
        bitpack.packed_len(c), o, f, s)
       for n, h, w, c, o, f, s, p, _ in CS.CONV_EXTRAS})


def _covers_once(slices, n_words):
    seen = np.zeros(n_words, np.int64)
    for lo, hi in slices:
        seen[lo:hi] += 1
    return bool((seen == 1).all())


def _check_k2_plan(m, n, kw):
    p = kmm.mxu_plan(m, n, kw)
    assert p.smem <= kmm.SMEM_PER_BLOCK
    assert p.cs in (1, 2, 4, 8) and p.cs <= kmm.MAX_CLUSTER
    assert p.bn in (16, 32, 64) and p.bm in (8, 16, 32, 64)
    assert p.pass_words % 8 == 0 and 8 <= p.pass_words <= kmm.K2_PASS
    assert p.cs <= p.steps                   # no rank without a step
    # every word of K once per (m16 tile, column): over ranks, passes and
    # the warps' k-slices
    assert _covers_once([(lo, hi) for _, _, lo, hi in p.k_slices()], kw)
    ranks = [p.rank_steps(r) for r in range(p.cs)]
    assert all(hi > lo for lo, hi in ranks)
    assert ranks[0][0] == 0 and ranks[-1][1] == p.steps
    return p


def _check_k4_plan(n, ho, wo, cw, o, f, s):
    p = kconv.mxu_plan(n, ho, wo, cw, o, f, f, s)
    assert p.smem <= kconv.SMEM_PER_BLOCK
    assert p.th in (1, 2, 4, 8) and p.bo in (16, 32, 64)
    assert p.lc % 8 == 0 and p.ks in (1, 2, 4)
    assert p.ks * p.units <= kconv.K4_THREADS // 32 or p.ks == 1
    assert p.sh == (p.th - 1) * s + f and p.sw == (kconv.TW - 1) * s + f
    assert p.pix >= cw and (p.pix == cw or s * p.pix % 8 == 4)
    assert _covers_once([(lo, hi) for _, lo, hi in p.l_slices()], p.ll)
    return p


@pytest.mark.parametrize("m,n,kw", MM_CASES)
def test_k2_plan_at_chip_smoke_cases(m, n, kw):
    _check_k2_plan(m, n, kw)


@pytest.mark.parametrize("n,ho,wo,cw,o,f,s", CONV_CASES)
def test_k4_plan_at_chip_smoke_cases(n, ho, wo, cw, o, f, s):
    _check_k4_plan(n, ho, wo, cw, o, f, s)


def test_path_shapes_launch_a_full_wave():
    """FC-1, FC-2 and CONV-2..6 at batch 4 launch at least 132 blocks (a
    block per SM of the H100); FC-3 (N = 10, Kw = 32) has one m16 tile and
    4 steps of 8 words, and takes each step in a block of its own."""
    fc = [kmm.mxu_plan(CS.N_SLOTS, n, bitpack.packed_len(k))
          for n, k, _ in CS.FC_SHAPES]
    assert [p.blocks for p in fc[:2]] == [256, 256]
    assert [p.cs for p in fc] == [4, 4, 4]
    assert fc[2].blocks == fc[2].steps == 4
    for h, c, o in CS.CONV_SHAPES:
        p = kconv.mxu_plan(CS.N_SLOTS, h, h, c // 32, o, 3, 3, 1)
        assert p.blocks >= kmm.WAVE, (h, c, o, p)
        assert p.lc >= p.ll                  # one pass of filter words


@pytest.mark.parametrize("chunk", range(4))
def test_k2_plan_sweep(chunk):
    rng = np.random.default_rng(1000 + chunk)
    for _ in range(400):
        m = int(rng.choice([1, 2, 4, 7, 16, 33, 257, 4096, 65536]))
        n = int(rng.integers(1, 5000))
        kw = int(rng.choice([1, 3, 4, 8, 9, 36, 144, 259, 1024, 3000]))
        _check_k2_plan(m, n, kw)


@pytest.mark.parametrize("chunk", range(4))
def test_k4_plan_sweep(chunk):
    """Every geometry either fits or is refused only where even th = 1,
    bo = 16 and 8 filter words a pass do not fit (the halo is too big)."""
    rng = np.random.default_rng(2000 + chunk)
    for _ in range(300):
        n = int(rng.integers(1, 9))
        ho, wo = (int(x) for x in rng.integers(1, 70, 2))
        cw = int(rng.choice([1, 2, 3, 4, 8, 16, 32, 64, 200]))
        o = int(rng.integers(1, 1100))
        f = int(rng.choice([1, 3, 5, 7]))
        s = int(rng.choice([1, 2, 3, 4]))
        try:
            _check_k4_plan(n, ho, wo, cw, o, f, s)
        except ValueError:
            pix = next((q for q in range(cw, cw + 8) if s * q % 8 == 4), cw)
            assert kconv._conv_smem(1, 16, 8, f, (kconv.TW - 1) * s + f, pix,
                                    f * f * cw) > kconv.SMEM_PER_BLOCK


def test_k2_plan_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.given(st.integers(1, 1 << 17), st.integers(1, 1 << 14),
               st.integers(1, 5000))
    @hyp.settings(max_examples=300, deadline=None)
    def check(m, n, kw):
        _check_k2_plan(m, n, kw)

    check()


def _consts(name):
    src = (_build.CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_k2_mirror_matches_cuda_constants():
    src, c = _consts("xnor_matmul.cu")
    _, bits = _consts("bits.cuh")
    assert c["K2_THREADS"] == kmm.K2_THREADS
    assert c["K2_PASS"] == kmm.K2_PASS and c["WAVE"] == kmm.WAVE
    assert bits["MAX_CLUSTER"] == kmm.MAX_CLUSTER
    assert bits["SMEM_LIMIT"] == kmm.SMEM_PER_BLOCK
    # the launcher's shared memory: both operands' rows at pass + 4 words,
    # the (bm x bn + 4) tile of partial sums
    assert "(static_cast<size_t>(p.bn + p.bm) * (p.pass + 4) +" in src
    assert "static_cast<size_t>(p.bm) * (p.bn + 4));" in src
    assert "p.bm = pow2_at_least(M, 8, 64);" in src
    assert "p.bn = pow2_at_least(N, 16, 64);" in src


def test_k4_mirror_matches_cuda_constants():
    src, c = _consts("xnor_conv.cu")
    assert c["K4_THREADS"] == kconv.K4_THREADS and c["K4_NT"] == kconv.K4_NT
    assert c["TH"] == kconv.TH and c["TW"] == kconv.TW
    assert c["WAVE"] == kmm.WAVE
    assert "p.bo = pow2_at_least(O, 16, 64);" in src
    assert "p.th = pow2_at_least(Ho, 1, TH);" in src
    body = re.search(r"size_t conv_smem_words\(.*?\n}\n", src, re.S).group(0)
    for term in ("static_cast<size_t>(p.bo) * (p.lc + 4)",
                 "static_cast<size_t>(p.sh) * p.sw * p.P + l8",
                 "static_cast<size_t>(tp) * (p.bo + 4)"):
        assert term in body


def test_probe_mirror_matches_cuda_constants():
    _, c = _consts("mma_probe.cu")
    assert c["PROBE_THREADS"] == 32 * mma_probe.WARPS_PER_BLOCK
    assert c["CHAINS"] == mma_probe.CHAINS
    assert [f for f, _ in mma_probe.FORMS.values()] == [0, 1, 2, 3]


# ------------------------------------------------ emulation vs the JAX mxu


def _pad_words(words: torch.Tensor, n_words: int) -> torch.Tensor:
    """int32 words as int64 in [0, 2^32), zero words up to n_words."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    return torch.nn.functional.pad(x, (0, n_words - x.shape[-1]))


def emulate_k2(a_words, w_words, k, plan):
    """K2's arithmetic: per rank, per pass, per warp k-slice, 8-word MMA
    steps of popc(a AND w) on zero-padded words, the share 2·D − popc(a)
    − popc(w) over the slice's words, summed; then 32·Kw − n_pad."""
    m, kw = a_words.shape
    a8 = _pad_words(a_words, 8 * plan.steps)
    w8 = _pad_words(w_words, 8 * plan.steps)
    total = torch.zeros((m, w_words.shape[0]), dtype=torch.int64)
    for _, _, lo, hi in plan.k_slices():
        if hi <= lo:
            continue
        d = torch.zeros_like(total)
        for s in range(lo // 8, -(-hi // 8)):          # one MMA each
            blk = slice(8 * s, 8 * s + 8)
            d += bitpack.popcount32(a8[:, None, blk] & w8[None, :, blk]).sum(-1)
        pa = bitpack.popcount32(a8[:, lo:hi]).sum(-1)
        pw = bitpack.popcount32(w8[:, lo:hi]).sum(-1)
        total += 2 * d - pa[:, None] - pw[None, :]
    n_pad = 32 * kw - k
    return (32 * kw - n_pad + total).to(torch.int32)


def emulate_k4(a_words, w_words, k, fh, fw, stride, pad, plan):
    """K4's arithmetic: each position's patch words gathered in (dy, dx,
    cw) order, zero words outside the image and past L; per pass and warp
    slice of L, 8-word MMA steps of popc(patch AND filter) and the share
    2·D − popc(patch) − popc(filter); then 32·L − n_pad."""
    n, h, w, cw = a_words.shape
    o, ll = w_words.shape
    ph, pw = pad
    ho = (h + 2 * ph - fh) // stride + 1
    wo = (w + 2 * pw - fw) // stride + 1
    x = torch.nn.functional.pad(a_words.to(torch.int64) & 0xFFFFFFFF,
                                (0, 0, pw, pw + stride * 8, ph,
                                 ph + stride * 8))
    taps = [x[:, dy:dy + stride * ho:stride, dx:dx + stride * wo:stride]
            for dy in range(fh) for dx in range(fw)]
    patch = _pad_words(torch.cat(taps, dim=-1), 8 * plan.steps)
    filt = _pad_words(w_words, 8 * plan.steps)
    total = torch.zeros((n, ho, wo, o), dtype=torch.int64)
    for _, lo, hi in plan.l_slices():
        if hi <= lo:
            continue
        d = torch.zeros_like(total)
        for s in range(lo // 8, -(-hi // 8)):
            blk = slice(8 * s, 8 * s + 8)
            d += bitpack.popcount32(patch[..., None, blk] & filt[:, blk]).sum(-1)
        px = bitpack.popcount32(patch[..., lo:hi]).sum(-1)
        pf = bitpack.popcount32(filt[:, lo:hi]).sum(-1)
        total += 2 * d - px[..., None] - pf
    return (32 * ll - (32 * ll - k) + total).to(torch.int32)


def _thresholds(rng, n, k):
    return (rng.integers(0, k + 1, (n,)).astype(np.float32),
            rng.integers(0, 2, (n,)).astype(bool))


# (M, N, k): Kw = 1, 3 (one ragged step), 9 and 37 (not multiples of 8),
# a split over a cluster of 4 with an uneven last rank (37 words, 5
# steps), one of 8 over 259 words (33 steps), and ragged M and N
MM_EMU = [(1, 1, 1), (5, 17, 70), (9, 33, 257), (4, 40, 37 * 32 - 3),
          (20, 10, 1170), (4, 64, 259 * 32 - 5)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("m,n,k", MM_EMU)
def test_k2_emulation_matches_jax_mxu(m, n, k, fused):
    rng = np.random.default_rng(m * 1000 + k)
    a = bitpack.pack_pm1(torch.from_numpy(rng.normal(size=(m, k))))
    w = bitpack.pack_pm1(torch.from_numpy(rng.normal(size=(n, k))))
    plan = kmm.mxu_plan(m, n, a.shape[1])
    thr, jthr = {}, {}
    if fused:
        c, f = _thresholds(rng, n, k)
        thr = dict(thr_c=torch.from_numpy(c), thr_flip=torch.from_numpy(f))
        jthr = dict(thr_c=jnp.asarray(c), thr_flip=jnp.asarray(f))
    want = np.asarray(jops.xnor_matmul(jnp.asarray(a.numpy()),
                                       jnp.asarray(w.numpy()), k=k,
                                       path="mxu", interpret=True, **jthr))
    got = emulate_k2(a, w, k, plan)
    if fused:
        got = ref.norm_binarize_ref(got, thr["thr_c"], thr["thr_flip"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_k2_emulation_splits_as_the_launcher_does():
    """The emulated shapes exercise clusters, warp splits and a ragged
    last rank; FC-1's plan is emulated too (against the plain version)."""
    plans = [kmm.mxu_plan(m, n, bitpack.packed_len(k)) for m, n, k in MM_EMU]
    assert {p.cs for p in plans} >= {1, 4, 8}
    p = kmm.mxu_plan(4, 40, 37)                 # 5 steps over 4 ranks
    assert [hi - lo for lo, hi in map(p.rank_steps, range(p.cs))] == \
        [1, 1, 1, 2]
    rng = np.random.default_rng(5)
    a_bits = torch.from_numpy(rng.integers(0, 2, (4, 8192)).astype(np.int8))
    w_bits = torch.from_numpy(rng.integers(0, 2, (1024, 8192)).astype(np.int8))
    a, w = bitpack.pack_bits(a_bits), bitpack.pack_bits(w_bits)
    plan = kmm.mxu_plan(4, 1024, 256)
    assert plan.cs == 4
    np.testing.assert_array_equal(
        emulate_k2(a, w, 8192, plan).numpy(),
        ref.xnor_matmul_ref(a, w, 8192).numpy())


# (n, h, w, c, o, f, stride, pad): Cw = 1 (L = 9, one ragged step), L not
# a multiple of 8 (Cw = 3: L = 27 and 75), halo positions outside the image
# on every side, stride 2, O = 17 (a ragged m16 tile), 8 words a step at
# Cw = 8 (L = 72), and an L split over warps
CONV_EMU = [(2, 6, 7, 32, 16, 3, 1, 1), (1, 9, 9, 96, 17, 3, 2, 1),
            (2, 7, 5, 64, 8, 5, 2, 2), (1, 5, 5, 256, 20, 3, 1, 1),
            (1, 11, 6, 96, 24, 5, 1, 2)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,h,w,c,o,f,s,p", CONV_EMU)
def test_k4_emulation_matches_jax_mxu(n, h, w, c, o, f, s, p, fused):
    rng = np.random.default_rng(h * 100 + c + s)
    a_bits = rng.integers(0, 2, (n, h, w, c)).astype(np.int8)
    w_pm1 = rng.choice([-1.0, 1.0], (o, f, f, c)).astype(np.float32)
    w_words = kconv.pack_conv_weights(torch.from_numpy(w_pm1))
    a_words = bitpack.pack_bits(bitpack.pad_to_pack(torch.from_numpy(a_bits)))
    k = f * f * c
    ho, wo = (h + 2 * p - f) // s + 1, (w + 2 * p - f) // s + 1
    plan = kconv.mxu_plan(n, ho, wo, a_words.shape[3], o, f, f, s)
    thr, jthr = {}, {}
    if fused:
        cc, ff = _thresholds(rng, o, k)
        thr = dict(thr_c=torch.from_numpy(cc), thr_flip=torch.from_numpy(ff))
        jthr = dict(thr_c=jnp.asarray(cc), thr_flip=jnp.asarray(ff))
    want = np.asarray(jops.xnor_conv2d(
        jnp.asarray(a_bits), jnp.asarray(w_words.numpy()), k=k, fh=f, fw=f,
        stride=s, pad=p, path="mxu", interpret=True, **jthr))
    got = emulate_k4(a_words, w_words, k, f, f, s, (p, p), plan)
    if fused:
        got = ref.norm_binarize_ref(got, thr["thr_c"], thr["thr_flip"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4_emulation_covers_split_l_and_passes():
    """The emulated shapes include an L split over warps; a plan with
    several passes of filter words (forced small lc) still covers L once
    and emulates to the plain version."""
    plans = [kconv.mxu_plan(n, (h + 2 * p - f) // s + 1,
                            (w + 2 * p - f) // s + 1, -(-c // 32), o, f, f, s)
             for n, h, w, c, o, f, s, p in CONV_EMU]
    assert max(pl.ks for pl in plans) > 1
    rng = np.random.default_rng(9)
    a_bits = torch.from_numpy(rng.integers(0, 2, (1, 6, 6, 96)).astype(np.int8))
    w_bits = torch.from_numpy(rng.integers(0, 2, (16, 3, 3, 96)).astype(np.int8))
    a_words = bitpack.pack_bits(bitpack.pad_to_pack(a_bits))
    w_words = kconv.pack_conv_weights(bitpack.decode_pm1(w_bits))
    base = kconv.mxu_plan(1, 6, 6, 3, 16, 3, 3, 1)
    plan = kconv.MxuConvPlan(**{**base.__dict__, "lc": 8})
    assert len({lo for _, lo, _ in plan.l_slices()}) > 1
    np.testing.assert_array_equal(
        emulate_k4(a_words, w_words, 9 * 96, 3, 3, 1, (1, 1), plan).numpy(),
        ref.xnor_conv2d_ref(a_bits, w_bits, stride=1, pad=1).numpy())
