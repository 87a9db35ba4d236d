"""K3 and K1, the BCNN's popcount route, as rebuilt for Hopper.

* K3 (``csrc/xnor_conv.cu::xnor_conv2d_vpu_kernel``): a block of 4 warps
  per (image, th x 8 tile, 32 channels), lane = output channel, 4
  positions a thread, the carry-save popcount of 16-byte units
  (``csrc/bits.cuh::xor_popc``), th chosen on the host (``vpu_plan``) so
  the blocks make a wave, L split over warps where a block has at most 2
  warp units.
* K1 (``csrc/xnor_matmul.cu``): a GEMV for M <= 16 (lanes split K in
  16-byte units, a group of 2^lg lanes per weight row, an xor butterfly of
  shuffles), else tiles of 32 weight rows x bm activation rows with K3's
  core, K in passes of at most 256 words.

The kernels build and run only on the card, where ``chip_smoke.py`` holds
them against ``kernels/ref.py``. Tested here:

* the Python mirrors of the launchers (``xnor_conv.py::vpu_plan``,
  ``xnor_matmul.py::vpu_plan``) against the ``.cu``'s constants and plan
  code, and the host's multiply-shift division of the tile index;
* that each plan covers every output, channel and K word exactly once, and
  makes at least a wave (132 blocks) at the Table 2 shapes at batch 4;
* numpy emulations of both kernels' order of arithmetic (the staged halo
  with its zero words, the warp items and K slices, the tap-row walk, the
  carry-save sums, the GEMV's lane groups and butterfly, the tiled passes)
  bit for bit against ``repro.kernels.ops.xnor_conv2d`` and
  ``xnor_matmul`` on path "vpu" (Pallas in interpret mode).
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
from repro_torch.kernels import _build
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_matmul as kmm

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k1_k3",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
WARPS = 4


def _consts(name):
    src = (_build.CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def _out_hw(h, w, f, stride, pad):
    return (h + 2 * pad - f) // stride + 1, (w + 2 * pad - f) // stride + 1


# Table 2 CONV-2..6 at the served batch: (n, ho, wo, cw, o) of each conv
T2_CONVS = [(CS.N_SLOTS, h, h, c // 32, o) for h, c, o in CS.CONV_SHAPES]


# ------------------------------------------------ mirrors vs the .cu

def test_k3_mirror_matches_cuda_constants():
    src, c = _consts("xnor_conv.cu")
    assert c["K3_THREADS"] == kconv.K3_THREADS
    assert c["K3_BO"] == kconv.K3_BO and c["VP"] == kconv.VP
    assert c["TH"] == kconv.TH and c["TW"] == kconv.TW
    assert c["WAVE"] == kmm.WAVE
    static = re.search(r"struct K3Static \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+) (\w+)(?:\[([^\]]+)\])?;", static) == [
        ("int", "red", "K3_WARPS / 2 * 32 * VP"), ("uint64_t", "bar", "")]
    assert kconv.K3_STATIC == 4 * (128 // 32 // 2) * 32 * 4 + 8
    assert "return V == 4 ? (L % 8 == 4 ? L : L + 4) : (L | 1);" in src
    plan = re.search(r"bool vpu_plan\(.*?\n}\n", src, re.S).group(0)
    for line in ("int th = pow2_at_least(Ho, 1, TH);",
                 "while (th > 1 && per_tile_row * ((Ho + th - 1) / th) "
                 "< WAVE) th /= 2;",
                 "const int sh = (th - 1) * stride + fh, sw = (TW - 1) * "
                 "stride + fw;",
                 "if (g->smem + sizeof(K3Static) <= repro::SMEM_LIMIT) "
                 "break;",
                 "g->tiles = repro::make_fastdiv(g->tiles_w);"):
        assert line in plan
    assert re.search(r"__launch_bounds__\(K3_THREADS, 4\)\n"
                     r"xnor_conv2d_vpu_kernel", src)
    # the Table 2 geometries at compile time, the rest generic
    for inst in ("<4, 3, 1, 4>", "<8, 3, 1, 4>", "<16, 3, 1, 4>",
                 "<0, 0, 0, 4>", "<0, 0, 0, 1>"):
        assert f"xnor_conv2d_vpu_kernel{inst}" in src
    # the core is the one K5 vpu runs
    assert "repro::run_units<K3_WARPS, VP, V," in src
    fused = (_build.CSRC / "xnor_conv_fused.cu").read_text()
    assert fused.count("repro::run_units<WARPS, VP, V,") == 2
    assert "xor_popc" not in fused.replace("xor_popc in", "")


def test_k1_mirror_matches_cuda_constants():
    src, c = _consts("xnor_matmul.cu")
    for name in ("K1_THREADS", "K1_GEMV_M", "K1_BN", "K1_VP", "K1_BM",
                 "K1_PASS"):
        assert c[name] == getattr(kmm, name), name
    plan = re.search(r"K1Plan k1_plan\(.*?\n}\n", src, re.S).group(0)
    for line in ("p.V = Kw % 4 == 0 ? 4 : 1;",
                 "p.gemv = M <= K1_GEMV_M;",
                 "p.mt = M <= 1 ? 1 : M == 2 ? 2 : 4;",
                 "while ((1 << p.lg) < units && p.lg < 5) ++p.lg;",
                 "const int rows_per_block = K1_WARPS << (5 - p.lg);",
                 "while (p.bm > 16 && nt * ((M + p.bm - 1) / p.bm) < WAVE) "
                 "p.bm /= 2;",
                 "p.kc = Kw < K1_PASS ? Kw : K1_PASS;",
                 "p.ls = p.V == 4 ? (p.kc % 8 == 4 ? p.kc : p.kc + 4) : "
                 "(p.kc | 1);",
                 "p.smem = sizeof(uint32_t) * static_cast<size_t>(K1_BN + "
                 "p.bm) * p.ls;"):
        assert line in plan, line
    assert "__launch_bounds__(K1_THREADS)\nxnor_gemv_kernel" in src
    assert "__launch_bounds__(K1_THREADS, 4)\nxnor_matmul_vpu_kernel" in src
    # the GEMV reads device memory straight into registers
    gemv = re.search(r"xnor_gemv_kernel\(.*?\n}\n", src, re.S).group(0)
    assert "__shared__" not in gemv and "__syncthreads" not in gemv
    assert "repro::csa_unit(" in gemv


def test_k1_k3_choose_16_byte_units_from_the_shape_alone():
    """No pointer test in K1's or K3's kernels or K1's launcher: the
    wrappers copy an operand that does not start on 16 bytes, so the plan
    (and its mirror) depends on the shape alone."""
    mm = (_build.CSRC / "xnor_matmul.cu").read_text()
    conv = (_build.CSRC / "xnor_conv.cu").read_text()
    for src, start, end in (
            (mm, "xnor_gemv_kernel(", "constexpr int K2_THREADS"),
            (mm, "int xnor_matmul_vpu(", "int xnor_matmul_mxu("),
            (conv, "xnor_conv2d_vpu_kernel(", "constexpr int K4_THREADS"),
            (conv, "int xnor_conv2d_vpu(", "int xnor_conv2d_mxu(")):
        body = src[src.index(start):src.index(end)]
        assert "uintptr_t" not in body and "aligned" not in body, start


def test_aligned16_copies_only_a_misaligned_operand():
    words = torch.arange(40, dtype=torch.int32)
    whole = words[:36].view(9, 4)
    assert kmm.aligned16(whole) is whole
    shifted = words[1:37].view(9, 4)              # starts 4 bytes in
    assert shifted.data_ptr() % 16 == 4
    copy = kmm.aligned16(shifted)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, shifted)


def _fastdiv(d):
    """csrc/bits.cuh::make_fastdiv."""
    sh = 0
    while (1 << sh) < d:
        sh += 1
    return ((1 << 32) * ((1 << sh) - d)) // d + 1, sh


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 12, 100, 131, 4097,
                               65535, 1 << 20, (1 << 31) - 1])
def test_fastdiv_divides_the_tile_index(d):
    mul, sh = _fastdiv(d)
    assert mul < 1 << 32
    rng = np.random.default_rng(d)
    xs = np.concatenate([np.arange(0, 5000), rng.integers(0, 1 << 31, 5000),
                         [(1 << 31) - 1, d - 1, d, 2 * d - 1]])
    for x in xs.tolist():
        if x >= 1 << 31:
            continue
        q = (((x * mul) >> 32) + x) >> sh
        assert q == x // d, (x, d)
    src = (_build.CSRC / "bits.cuh").read_text()
    assert "((1ull << 32) * ((1ull << l) - d)) / d + 1;" in src
    assert "return (__umulhi(x, f.mul) + x) >> f.shift;" in src


# ------------------------------------------------ K3 plan coverage

def _k3_cover(n, ho, wo, cw, o, fh, fw, stride):
    """Outputs of every block, in the kernel's order: (tile, channel group,
    image) blocks, warp items of 4 positions x 32 lanes, K slices of each
    item. Returns the plan and {(img, oh, ow, ch): [K units]}."""
    plan = kconv.vpu_plan(n, ho, wo, cw, o, fh, fw, stride)
    nv = plan.ll // plan.vec
    ks = plan.ks
    lks = ks.bit_length() - 1
    tiles_w = -(-wo // kconv.TW)
    seen = {}
    gx, gy, gz = plan.grid
    for bx in range(gx):
        ty, tx = bx // tiles_w, bx % tiles_w
        for by in range(gy):
            for img in range(gz):
                for i in range(plan.units * ks):
                    pb, sl = i % plan.units, i // plan.units
                    u0, u1 = (nv * sl) >> lks, (nv * (sl + 1)) >> lks
                    oh = ty * plan.th + pb * kconv.VP // kconv.TW
                    ow0 = tx * kconv.TW + pb * kconv.VP % kconv.TW
                    for j in range(kconv.VP):
                        for lane in range(32):
                            ch = by * kconv.K3_BO + lane
                            if oh < ho and ow0 + j < wo and ch < o:
                                seen.setdefault((img, oh, ow0 + j, ch),
                                                []).extend(range(u0, u1))
    return plan, seen


K3_COVER = [(1, 4, 4, 4, 64, 3, 3, 1), (2, 5, 5, 2, 40, 3, 3, 2),
            (1, 9, 10, 2, 17, 3, 3, 1), (1, 3, 4, 3, 48, 5, 5, 2),
            (2, 7, 9, 8, 33, 3, 3, 1), (1, 1, 1, 16, 32, 3, 3, 1),
            (3, 12, 5, 1, 16, 3, 3, 1)]


@pytest.mark.parametrize("case", K3_COVER)
def test_k3_plan_covers_every_output_channel_and_word_once(case):
    plan, seen = _k3_cover(*case)
    n, ho, wo, _, o, *_ = case
    assert len(seen) == n * ho * wo * o
    nv = plan.ll // plan.vec
    for units in seen.values():
        assert sorted(units) == list(range(nv))
    # a K split only where the block has at most 2 warp units (VpuStatic
    # holds their sums)
    assert plan.ks == 1 or plan.units <= WARPS // 2


@pytest.mark.parametrize("n,ho,wo,cw,o", T2_CONVS)
def test_k3_plan_fills_a_wave_at_table2(n, ho, wo, cw, o):
    plan = kconv.vpu_plan(n, ho, wo, cw, o, 3, 3, 1)
    assert plan.blocks >= kmm.WAVE
    assert plan.vec == 4 and plan.ks == 1
    # rows at a stride of 4 mod 8 words: 8 rows, 8 bank groups
    assert plan.ls % 8 == 4
    assert plan.smem + kconv.K3_STATIC <= kmm.SMEM_PER_BLOCK
    # CONV-2 at th 8, CONV-3/4 at 4, CONV-5/6 at 2: 256 blocks each
    assert (plan.th, plan.blocks) == ({32: 8, 16: 4, 8: 2}[ho], 256)


@pytest.mark.parametrize("case", CS.CONV_EXTRAS)
def test_k3_plan_at_every_chip_smoke_extra(case):
    """Every chip_smoke extra has a plan whose block fits, with 16-byte
    units exactly where Cw % 4 == 0."""
    n, h, w, c, o, f, stride, pad, _ = case
    ho, wo = _out_hw(h, w, f, stride, pad)
    cw = -(-c // 32)
    plan = kconv.vpu_plan(n, ho, wo, cw, o, f, f, stride)
    assert plan.smem + kconv.K3_STATIC <= kmm.SMEM_PER_BLOCK
    assert plan.vec == (4 if cw % 4 == 0 else 1)


def test_k3_extras_reach_each_instantiation():
    kinds = set()
    for n, h, w, c, o, f, stride, pad, _ in CS.CONV_EXTRAS:
        cw = -(-c // 32)
        t2 = f == 3 and stride == 1
        kinds.add("t2" if t2 and cw in (4, 8, 16)
                  else "generic16" if cw % 4 == 0 else "generic4")
        ho, wo = _out_hw(h, w, f, stride, pad)
        plan = kconv.vpu_plan(n, ho, wo, cw, o, f, f, stride)
        if plan.ks > 1:
            kinds.add(f"split{plan.vec}")
        if o % kconv.K3_BO:
            kinds.add("ragged_o")
        if cw == 1:
            kinds.add("cw1")
        if stride == 2:
            kinds.add("stride2")
    assert kinds >= {"t2", "generic16", "generic4", "split4", "split1",
                     "ragged_o", "cw1", "stride2"}


# ------------------------------------------------ K1 plan coverage

def _k1_cover(m, n, kw):
    """{(row, col): [K words added]} over every block of K1's plan."""
    plan = kmm.vpu_plan(m, n, kw)
    seen = {}
    gx, gy = plan.grid
    if plan.gemv:
        for bx in range(gx):
            for by in range(gy):
                for warp in range(WARPS):
                    groups = {}
                    for lane in range(32):
                        col, rows, units, stored = plan.gemv_lane(bx, by,
                                                                  warp, lane)
                        groups.setdefault(lane >> plan.lg, []).append(
                            (col, rows, units, stored))
                    for members in groups.values():
                        col, rows = members[0][0], members[0][1]
                        words = sorted(plan.vec * u + i
                                       for _, _, units, _ in members
                                       for u in units for i in range(plan.vec))
                        for _, _, _, stored in members:
                            for row in stored:
                                assert (row, col) not in seen
                                seen[(row, col)] = words
        return plan, seen
    for bx in range(gx):
        for by in range(gy):
            for warp in range(WARPS):
                for t in range(kmm.K1_BM // kmm.K1_VP // WARPS):
                    pb = warp + WARPS * t
                    if pb >= plan.bm // kmm.K1_VP:
                        continue
                    for j in range(kmm.K1_VP):
                        for lane in range(32):
                            row = bx * plan.bm + pb * kmm.K1_VP + j
                            col = by * kmm.K1_BN + lane
                            if row < m and col < n:
                                assert (row, col) not in seen
                                seen[(row, col)] = sorted(
                                    k0 + i for k0, kn in plan.passes()
                                    for i in range(kn))
    return plan, seen


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 16, 17, 37, 64, 130])
@pytest.mark.parametrize("n,kw", [(1, 1), (77, 2), (128, 4), (128, 8),
                                  (1000, 37), (65, 259), (10, 32),
                                  (300, 600)])
def test_k1_plan_covers_every_output_and_word_once(m, n, kw):
    plan, seen = _k1_cover(m, n, kw)
    assert plan.gemv == (m <= kmm.K1_GEMV_M)
    assert sorted(seen) == [(i, j) for i in range(m) for j in range(n)]
    for words in seen.values():
        assert words == list(range(kw))
    if plan.gemv:
        assert 1 << plan.lg == min(32, 1 << (kw // plan.vec - 1).bit_length())
    else:
        assert plan.smem <= kmm.SMEM_PER_BLOCK
        assert plan.ls % 8 == 4 if plan.vec == 4 else plan.ls % 2 == 1


def test_k1_plan_at_the_served_shapes():
    """FC-1..3 at batch 4 and the LM's "xnor" step take the GEMV (FC-1 at
    256 blocks of 4 weight rows); the im2col shapes take tiles that fill a
    wave; M = 16 / 17 sit on either side of the switch."""
    fc1 = kmm.vpu_plan(CS.N_SLOTS, 1024, 256)
    assert fc1.gemv and fc1.lg == 5 and fc1.blocks == 256
    for n, k, _ in CS.FC_SHAPES:
        assert kmm.vpu_plan(CS.N_SLOTS, n, bitpack.packed_len(k)).gemv
    for k, n in CS.BW_CALLS:
        p = kmm.vpu_plan(CS.N_SLOTS, n, k // 32)
        assert p.gemv and p.mt == 4 and (1 << p.lg) == k // 128
    for h, c, o in CS.CONV_SHAPES:
        p = kmm.vpu_plan(CS.N_SLOTS * h * h, o, 9 * c // 32)
        assert not p.gemv and p.blocks >= kmm.WAVE and len(p.passes()) == 1
    assert kmm.vpu_plan(16, 1024, 256).gemv
    assert not kmm.vpu_plan(17, 1024, 256).gemv
    for m, n, k, _ in CS.MM_EXTRAS:
        kmm.vpu_plan(m, n, bitpack.packed_len(k))


# ------------------------------------------------ numpy emulations

def _u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


def _csa(ones, twos, d):
    """csrc/bits.cuh::csa_unit on arrays: d (..., 4) XOR words."""
    d0, d1, d2, d3 = (d[..., i] for i in range(4))
    c1 = (ones & d0) | (ones & d1) | (d0 & d1)
    s1 = ones ^ d0 ^ d1
    c2 = (s1 & d2) | (s1 & d3) | (d2 & d3)
    return s1 ^ d2 ^ d3, twos + _popc(c1) + _popc(c2)


def _xor_popc(frows, src, base, src_row, nrow, u0, u1, vec):
    """csrc/bits.cuh::xor_popc for 32 lanes x VP positions: frows (32,
    L) filter rows, src the staged words, base (VP,) patch starts.
    Returns (32, VP) sums of popc(x XOR w) in the kernel's order."""
    dy, r = 0, u0
    while r >= nrow:
        r -= nrow
        dy += 1
    off = dy * src_row + r * vec
    vp = len(base)
    ones = np.zeros((32, vp), np.uint32)
    twos = np.zeros((32, vp), np.int64)
    dis = np.zeros((32, vp), np.int64)
    for u in range(u0, u1):
        w = frows[:, u * vec:(u + 1) * vec]                   # (32, vec)
        x = np.stack([src[b + off:b + off + vec] for b in base])  # (vp, vec)
        d = w[:, None, :] ^ x[None, :, :]                     # (32, vp, vec)
        if vec == 4:
            ones, twos = _csa(ones, twos, d)
        else:
            dis += _popc(d[..., 0])
        off += vec
        r += 1
        if r == nrow:
            r = 0
            off += src_row - nrow * vec
    return dis + _popc(ones) + 2 * twos


def emulate_k3(a_words, w_words, *, k, fh, fw, stride, pad, thr=None,
               garbage=None):
    """K3's arithmetic block by block: the staged halo (zero words outside
    the image), the filter rows (rows past O hold ``garbage``, as shared
    memory would), each warp item's K slices through xor_popc, the sums of
    split slices added, agree = 32 L - dis - n_pad, eq. 8."""
    n, h, w, cw = a_words.shape
    o, ll = w_words.shape
    ho, wo = _out_hw(h, w, fh, stride, pad)
    plan = kconv.vpu_plan(n, ho, wo, cw, o, fh, fw, stride)
    vec, nv, th, sh, sw = plan.vec, ll // plan.vec, plan.th, plan.sh, plan.sw
    ks, lks = plan.ks, plan.ks.bit_length() - 1
    kp = 32 * ll - (ll * 32 - k)
    a32, w32 = _u32(a_words), _u32(w_words)
    tiles_w = -(-wo // kconv.TW)
    out = np.zeros((n, ho, wo, o), np.int8 if thr else np.int32)
    written = np.zeros((n, ho, wo, o), bool)
    gx, gy, gz = plan.grid
    for bx in range(gx):
        mul, shf = _fastdiv(tiles_w)
        ty = (((bx * mul) >> 32) + bx) >> shf
        tx = bx - ty * tiles_w
        oh0, ow0 = ty * th, tx * kconv.TW
        for by in range(gy):
            o0 = by * kconv.K3_BO
            rows = min(kconv.K3_BO, o - o0)
            frows = np.empty((32, ll), np.uint32)
            frows[:rows] = w32[o0:o0 + rows]
            frows[rows:] = garbage if garbage is not None else 0
            for img in range(gz):
                xs = np.zeros((sh, sw, cw), np.uint32)
                for y in range(sh):
                    for x in range(sw):
                        ih, iw = oh0 * stride - pad + y, ow0 * stride - pad + x
                        if 0 <= ih < h and 0 <= iw < w:
                            xs[y, x] = a32[img, ih, iw]
                src = xs.ravel()
                sums = {}
                for i in range(plan.units * ks):
                    pb, sl = i % plan.units, i // plan.units
                    base = [((p // kconv.TW) * stride * sw
                             + (p % kconv.TW) * stride) * cw
                            for p in range(pb * kconv.VP, (pb + 1) * kconv.VP)]
                    dis = _xor_popc(frows, src, base, sw * cw, fw * cw // vec,
                                    (nv * sl) >> lks, (nv * (sl + 1)) >> lks,
                                    vec)
                    sums[pb] = sums.get(pb, 0) + dis
                for pb, dis in sums.items():
                    oh = oh0 + pb * kconv.VP // kconv.TW
                    ow = ow0 + pb * kconv.VP % kconv.TW
                    for j in range(kconv.VP):
                        for lane in range(rows):
                            if oh < ho and ow + j < wo:
                                y = kp - int(dis[lane, j])
                                ch = o0 + lane
                                if thr:
                                    y = int((np.float32(y) >= thr[0][ch])
                                            != thr[1][ch])
                                assert not written[img, oh, ow + j, ch]
                                written[img, oh, ow + j, ch] = True
                                out[img, oh, ow + j, ch] = y
    assert written.all()
    return out


# (n, h, w, c, o, f, stride, pad): small Table 2 layouts (Cw 4, 8, 16; 3 x
# 3, stride 1, compile-time in the kernel), one of them at th = 1 with L
# split over warps; stride 2 with 16-byte units; a 5 x 5; ragged O;
# 4-byte units (Cw 1, 2, 3)
K3_EMU = [(1, 6, 6, 128, 64, 3, 1, 1), (2, 4, 4, 256, 32, 3, 1, 1),
          (1, 3, 3, 512, 40, 3, 1, 1), (1, 2, 2, 128, 32, 3, 1, 1),
          (1, 7, 7, 128, 40, 3, 2, 1), (1, 5, 6, 256, 24, 5, 1, 2),
          (2, 5, 5, 32, 17, 3, 1, 1), (1, 7, 6, 64, 33, 3, 2, 1),
          (1, 6, 5, 96, 48, 5, 2, 2)]


@pytest.mark.parametrize("n,h,w,c,o,f,stride,pad", K3_EMU)
@pytest.mark.parametrize("fused", [False, True])
def test_k3_emulation_matches_jax_vpu(n, h, w, c, o, f, stride, pad, fused):
    rng = np.random.default_rng(n * 1000 + h * 100 + c + o + f + fused)
    a_bits = rng.integers(0, 2, (n, h, w, c)).astype(np.int8)
    wf = rng.choice([-1.0, 1.0], (o, f, f, c)).astype(np.float32)
    k = f * f * c
    w_words = kconv.pack_conv_weights(torch.from_numpy(wf)).numpy()
    a_words = bitpack.pack_bits(bitpack.pad_to_pack(
        torch.from_numpy(a_bits))).numpy()
    thr, jthr = None, {}
    if fused:
        cc = rng.integers(k // 3, 2 * k // 3, o).astype(np.float32)
        ff = rng.integers(0, 2, o).astype(bool)
        thr, jthr = (cc, ff), dict(thr_c=jnp.asarray(cc),
                                   thr_flip=jnp.asarray(ff))
    want = np.asarray(jops.xnor_conv2d(
        jnp.asarray(a_bits), jnp.asarray(w_words), k=k, fh=f, fw=f,
        stride=stride, pad=pad, path="vpu", **jthr))
    got = emulate_k3(a_words, w_words, k=k, fh=f, fw=f, stride=stride,
                     pad=pad, thr=thr,
                     garbage=rng.integers(0, 1 << 32, dtype=np.uint64))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def emulate_k1(a_words, w_words, *, k, thr=None):
    """K1's arithmetic. GEMV: per warp, every lane's units through the
    carry-save core for each of its MT rows, the group's sums added over
    the butterfly's offsets, each row stored by lane r mod 2^lg. Tiled: per
    block and pass, each warp unit's xor_popc over the pass's words, the
    sums carried across passes in registers."""
    m, kw = a_words.shape
    n = w_words.shape[0]
    plan = kmm.vpu_plan(m, n, kw)
    vec, kp = plan.vec, 32 * kw - (kw * 32 - k)
    a32, w32 = _u32(a_words), _u32(w_words)
    out = np.zeros((m, n), np.int8 if thr else np.int32)
    written = np.zeros((m, n), bool)

    def store(row, col, dis):
        y = kp - int(dis)
        if thr:
            y = int((np.float32(y) >= thr[0][col]) != thr[1][col])
        assert not written[row, col]
        written[row, col] = True
        out[row, col] = y

    gx, gy = plan.grid
    lanes = np.arange(32)
    if plan.gemv:
        lpc, mt = 1 << plan.lg, plan.mt
        for bx in range(gx):
            for by in range(gy):
                for warp in range(WARPS):
                    info = [plan.gemv_lane(bx, by, warp, ln) for ln in lanes]
                    cols = np.array([min(i[0], n - 1) for i in info])
                    rows = np.minimum(np.array(info[0][1]), m - 1)
                    ones = np.zeros((32, mt), np.uint32)
                    twos = np.zeros((32, mt), np.int64)
                    dis = np.zeros((32, mt), np.int64)
                    for it in range(max(len(i[2]) for i in info)):
                        live = np.array([it < len(i[2]) for i in info])
                        us = np.array([i[2][it] if it < len(i[2]) else 0
                                       for i in info])
                        idx = us[:, None] * vec + np.arange(vec)
                        wv = w32[cols[:, None], idx]               # (32, vec)
                        x = a32[rows[None, :, None], idx[:, None, :]]
                        d = wv[:, None, :] ^ x                 # (32, mt, vec)
                        d[~live] = 0
                        if vec == 4:
                            ones, twos = _csa(ones, twos, d)
                        else:
                            dis += _popc(d[..., 0])
                    dis = dis + _popc(ones) + 2 * twos
                    for o in (16, 8, 4, 2, 1):
                        if o < lpc:
                            dis = dis + dis[lanes ^ o]
                    for ln, (col, rws, _, stored) in enumerate(info):
                        for r, row in enumerate(rws):
                            if row in stored:
                                assert r % lpc == ln % lpc
                                store(row, col, dis[ln, r])
    else:
        units = plan.bm // kmm.K1_VP
        for bx in range(gx):
            for by in range(gy):
                m0, n0 = bx * plan.bm, by * kmm.K1_BN
                acc = np.zeros((WARPS, kmm.K1_BM // kmm.K1_VP // WARPS, 32,
                                kmm.K1_VP), np.int64)
                for k0, kn in plan.passes():
                    ws = np.zeros((32, kn), np.uint32)
                    wr = min(kmm.K1_BN, n - n0)
                    ws[:wr] = w32[n0:n0 + wr, k0:k0 + kn]
                    as_ = np.zeros((plan.bm, kn), np.uint32)
                    ar = min(plan.bm, m - m0)
                    as_[:ar] = a32[m0:m0 + ar, k0:k0 + kn]
                    src = as_.ravel()
                    nv = kn // vec
                    for warp in range(WARPS):
                        for t in range(acc.shape[1]):
                            pb = warp + WARPS * t
                            if pb < units:
                                base = [(pb * kmm.K1_VP + j) * kn
                                        for j in range(kmm.K1_VP)]
                                acc[warp, t] += _xor_popc(ws, src, base, 0,
                                                          nv, 0, nv, vec)
                for warp in range(WARPS):
                    for t in range(acc.shape[1]):
                        pb = warp + WARPS * t
                        for j in range(kmm.K1_VP):
                            row = m0 + pb * kmm.K1_VP + j
                            for lane in range(32):
                                col = n0 + lane
                                if pb < units and row < m and col < n:
                                    store(row, col, acc[warp, t, lane, j])
    assert written.all()
    return out


# (m, n, k): the GEMV at M = 1, 2, 4 and 16 (row tiles 1, 2, 4; lane
# groups of 1 (Kw 4), 2 (Kw 8), 8, 16 and 32 lanes; 4-byte units at
# ragged Kw); the tiled kernel at M = 17 and 64 (16-byte and 4-byte
# units, ragged N, K in 2 and 3 passes)
K1_EMU = [(4, 128, 128), (4, 64, 256), (1, 40, 1024), (2, 33, 1100),
          (16, 20, 4096 + 64), (3, 9, 33), (4, 10, 8192), (17, 40, 1152),
          (64, 33, 70), (17, 70, 259 * 32 - 5), (20, 36, 600 * 32)]


@pytest.mark.parametrize("m,n,k", K1_EMU)
@pytest.mark.parametrize("fused", [False, True])
def test_k1_emulation_matches_jax_vpu(m, n, k, fused):
    rng = np.random.default_rng(m * 10000 + n * 10 + k + fused)
    a_bits = torch.from_numpy(rng.integers(0, 2, (m, k)).astype(np.int8))
    w_bits = torch.from_numpy(rng.integers(0, 2, (n, k)).astype(np.int8))
    a = bitpack.pack_bits(bitpack.pad_to_pack(a_bits)).numpy()
    w = bitpack.pack_bits(bitpack.pad_to_pack(w_bits)).numpy()
    thr, jthr = None, {}
    if fused:
        cc = rng.integers(k // 3, 2 * k // 3 + 1, n).astype(np.float32)
        ff = rng.integers(0, 2, n).astype(bool)
        thr, jthr = (cc, ff), dict(thr_c=jnp.asarray(cc),
                                   thr_flip=jnp.asarray(ff))
    want = np.asarray(jops.xnor_matmul(jnp.asarray(a), jnp.asarray(w), k=k,
                                       path="vpu", **jthr))
    got = emulate_k1(a, w, k=k, thr=thr)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plan = kmm.vpu_plan(m, n, a.shape[1])
    assert plan.gemv == (m <= 16)
