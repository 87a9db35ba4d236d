"""K5 vpu and K6 as rebuilt for Hopper.

* K5 vpu (``csrc/xnor_conv_fused.cu::pair_vpu_kernel``): a thread-block
  cluster per (image, tile), conv A's channels split over the ranks, the
  A bit map shared through distributed shared memory, conv B's channels
  split again; lane = filter row, 4 positions a thread, and a carry-save
  popcount of 16-byte units.
* K6 (``csrc/binary_weight_matmul.cu``): a decode-shaped GEMV, one warp per
  4 output columns and a row tile that holds M, K split over the lanes, a
  reduce-scatter butterfly of shuffles.

The kernels build and run only on the card, where ``chip_smoke.py`` holds
them against ``kernels/ref.py``. Tested here:

* the Python mirrors of the launchers: the vpu shared memory
  (``halo_scratch``, ``vpu_pass_rows``) by hand at both Table 2 pairs and
  a ``PAIR_EXTRAS`` geometry, and against the ``.cu``'s constants; the
  cluster's channel split and the kernel's passes, row groups and warp
  items covering every channel, position and K unit exactly once; K6's
  grid (``bw_plan``) covering every output and every K word exactly once;
* numpy emulations of both kernels' order of arithmetic against the JAX
  package's kernels on the same inputs: the vpu pair (position tables,
  the tap-row walk of each K slice, the carry-save sums, the halo mask,
  the flip-aware pool) bit for bit against ``xnor_conv2d_pair`` on its
  Pallas "vpu" kernel in interpret mode; K6's float32 sums (each lane's
  four products in order, then the butterfly) exactly on ±1 activations
  and within the tolerances of tests/test_torch_bw_matmul.py on real ones
  against ``binary_weight_matmul``.
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
from repro_torch.kernels import autotune as at
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_conv_fused as kfused
from repro_torch.kernels import xnor_matmul as kmm

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_vpu_bw",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


def _geom(c, oa, fa, fb, pool):
    return dict(pf=2 if pool else 1, fha=fa, fwa=fa, cwa=c // 32, fhb=fb,
                fwb=fb, oa=oa)


# ------------------------------------------------ vpu shared memory mirror

@pytest.mark.parametrize("tile,geom,want", [
    # CONV-3/4 at (1, 2): halo 6 x 8 x 4 words, map 4 x 6 x 8 words; 32
    # conv A rows of 36 words and 64 conv B rows of 72, as they lie (one
    # TMA bulk copy each); tables 24 A-halo positions, 8 conv B positions,
    # 2 outputs rounded to 4; split-K sums and two mbarriers
    ((1, 2), _geom(128, 256, 3, 3, True),
     4 * (6 * 8 * 4 + 4 * 6 * 8 + 32 * 36 + 64 * 72 + 24 + 8 + 4) + 2064),
    # CONV-5/6 at (1, 1): halo 6 x 6 x 8, map 4 x 4 x 16; 64 rows of 72
    # words and 64 rows of 144; tables 16, 4 and 1 -> 4
    ((1, 1), _geom(256, 512, 3, 3, True),
     4 * (6 * 6 * 8 + 4 * 4 * 16 + 64 * 72 + 64 * 144 + 16 + 4 + 4) + 2064),
    # PAIR_EXTRAS (2, 10, 6, 32, 32, 40, 5, 3, True) at (1, 1): CwA 1, so
    # 4-byte loads and odd strides; halo 8 x 8 x 1, map 4 x 4 x 1; 32 rows
    # of 25 words, 64 rows of 9
    ((1, 1), _geom(32, 32, 5, 3, True),
     4 * (8 * 8 + 4 * 4 + 32 * 25 + 64 * 9 + 16 + 4 + 4) + 2064),
])
def test_vpu_halo_scratch_bytes_by_hand(tile, geom, want):
    assert kfused.halo_scratch(*tile, variant="vpu", **geom) == want
    assert kfused.vpu_pass_rows(*tile, **geom) == 64
    assert kfused.VPU_STATIC_BYTES == 2064


def test_vpu_strides():
    """16-byte units: rows as they lie (one bulk copy a conv); 4-byte
    words: an odd stride, so 32 rows lie in 32 banks."""
    for words in range(1, 600):
        if words % 4 == 0:
            assert kfused.vpu_stride(words, 4) == words
        st1 = kfused.vpu_stride(words, 1)
        assert st1 % 2 == 1 and 0 <= st1 - words <= 1
        assert len({(r * st1) % 32 for r in range(32)}) == 32


def test_vpu_pass_rows_halve_until_the_block_fits():
    geom = dict(pf=2, fha=3, fwa=3, cwa=32, fhb=3, fwb=3, oa=2048)
    assert kfused.vpu_pass_rows(4, 8, **geom) == 32
    assert kfused.vpu_pass_rows(1, 1, **dict(geom, oa=1024)) == 64
    assert kfused.halo_scratch(4, 8, variant="vpu", **geom) \
        <= kfused.SMEM_PER_BLOCK


def _consts(name):
    src = (_build.CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_vpu_mirror_matches_cuda_constants():
    """VP positions a thread, VR rows a pass, VpuStatic = one int per
    (lane, position) of WARPS / 2 units, 256 threads at 4 blocks an SM;
    the stride rule and the launcher's shared-memory terms, and the
    cluster split computed on the host."""
    src, c = _consts("xnor_conv_fused.cu")
    assert c["VP"] == kfused.VPU_POSITIONS and c["VR"] == kfused.VPU_ROWS
    assert c["THREADS"] == 256
    static = re.search(r"struct VpuStatic \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+) (\w+)\[([^\]]+)\];", static) == [
        ("int", "red", "WARPS / 2 * 32 * VP"), ("uint64_t", "bar", "2")]
    assert kfused.VPU_STATIC_BYTES == 4 * (8 // 2) * 32 * c["VP"] + 8 * 2
    assert "return V == 4 ? L : (L | 1);" in src
    body = re.search(r"size_t vpu_words\(.*?\n}\n", src, re.S).group(0)
    for term in ("map_words(g, pf)",
                 "static_cast<size_t>(ra) * vpu_stride(LA, V)",
                 "static_cast<size_t>(mr) * vpu_stride(LB, V)",
                 "round_vp(pa)", "round_vp(q * pf * pf)", "round_vp(q)"):
        assert term in body
    assert "const int V = CwA % 4 == 0 && oaw % 4 == 0 ? 4 : 1;" in src
    assert "if (mr == 32 || smem + VPU_STATIC <= repro::SMEM_LIMIT) break;" \
        in src
    assert re.search(r"__launch_bounds__\(THREADS, 4\)\npair_vpu_kernel", src)
    assert ("g.ob_split[r] = r <= g.csize ? (r * OB + g.csize - 1) / g.csize"
            " : OB;") in src
    # the Table 2 pairs at compile time: 3x3, CwA 4 / 8, OA/32 8 / 16
    assert "pair_vpu_kernel<2, 3, 4, 8, 4>" in src
    assert "pair_vpu_kernel<2, 3, 8, 16, 4>" in src


# ------------------------------------------ the vpu cluster and its work

def ks_split(units: int, nv: int) -> int:
    """The kernel's K split (run_units): doubled while twice the items
    still fit the 8 warps and each slice keeps a unit."""
    ks = 1
    while 2 * ks * units <= 8 and 2 * ks <= nv:
        ks *= 2
    return ks


def vpu_items(groups: int, nb: int, nv: int):
    """(warp, slice, position block, row group, first unit, end unit) of
    every warp item of one pass, in the kernel's order."""
    ks = ks_split(groups * nb, nv)
    lks = ks.bit_length() - 1
    out, i = [], 0
    for sl in range(ks):
        for pb in range(nb):
            for grp in range(groups):
                out.append((i % 8, sl, pb, grp, (nv * sl) >> lks,
                            (nv * (sl + 1)) >> lks))
                i += 1
    return out


def vpu_channel_cover(oa: int, ob: int, mr: int):
    """(conv A channels, conv B channels) that the ranks' passes and row
    groups compute, lanes past a share masked as the kernel masks them."""
    _, oa_rng, ob_rng = kfused.mxu_split(oa, ob)
    got_a, got_b = [], []
    for (a0, a1), (b0, b1) in zip(oa_rng, ob_rng):
        for r0 in range(0, a1 - a0, mr):
            rows = min(mr, a1 - a0 - r0)
            assert rows % 32 == 0
            got_a += [a0 + r0 + 32 * g + lane for g in range(rows // 32)
                      for lane in range(32)]
        for r0 in range(b0, b1, mr):
            rows = min(mr, b1 - r0)
            got_b += [o for g in range(-(-rows // 32)) for lane in range(32)
                      if (o := r0 + 32 * g + lane) < b1]
    return got_a, got_b


@pytest.mark.parametrize("oa,ob", [(256, 256), (512, 512), (32, 32),
                                   (32, 40), (64, 32), (96, 40), (64, 40),
                                   (256, 200), (96, 5), (2048, 1000)])
@pytest.mark.parametrize("mr", [64, 32])
def test_vpu_cluster_covers_every_channel_once(oa, ob, mr):
    """Clusters of C < 8 (OA = 32, 64, 96), uneven and ragged OB shares,
    empty shares (OB = 5 over C = 3), and shares of several passes."""
    got_a, got_b = vpu_channel_cover(oa, ob, mr)
    assert sorted(got_a) == list(range(oa)) == got_a
    assert sorted(got_b) == list(range(ob))


@pytest.mark.parametrize("case", [(CS.N_SLOTS, h, h, c, oa, ob, 3, 3, True)
                                  for h, c, oa, ob in CS.PAIR_SHAPES]
                         + list(CS.PAIR_EXTRAS))
def test_vpu_items_cover_every_position_and_unit(case):
    """At every legal tile of every chip_smoke case: each pass's warp
    items cover every (row group, position block) once per K slice, the
    slices cover every K unit exactly once, every item's warp is one of
    8, and a K split has at most 4 units (the size of VpuStatic)."""
    n, h, w, c, oa, ob, fa, fb, pool = case
    geom = _geom(c, oa, fa, fb, pool)
    pf, csize = geom["pf"], kfused.mxu_split(oa, ob)[0]
    vec = 4 if c // 32 % 4 == 0 and oa // 32 % 4 == 0 else 1
    for th, tw in at.tile_candidates(h // pf, w // pf, **geom):
        mr = kfused.vpu_pass_rows(th, tw, **geom)
        pa = (pf * th + fb - 1) * (pf * tw + fb - 1)
        rows_b = min(mr, -(-ob // csize))
        for groups, npos, words in (
                (min(mr, oa // csize) // 32, pa, fa * fa * c // 32),
                (-(-rows_b // 32), th * tw * pf * pf, fb * fb * oa // 32)):
            nb, nv = -(-npos // 4), words // vec
            items = vpu_items(groups, nb, nv)
            ks = max(it[1] for it in items) + 1
            assert ks == 1 or groups * nb <= 4
            seen = {}
            for warp, _, pb, grp, u0, u1 in items:
                assert 0 <= warp < 8
                seen.setdefault((pb, grp), []).append((u0, u1))
            assert sorted(seen) == [(pb, g) for pb in range(nb)
                                    for g in range(groups)]
            for spans in seen.values():
                units = [u for u0, u1 in spans for u in range(u0, u1)]
                assert units == list(range(nv))


# ------------------------------------------------ K6 launch-plan mirror

@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 16, 37, 128])
@pytest.mark.parametrize("k,n", sorted(CS.BW_CALLS) + [(40, 33), (1100, 77)])
def test_bw_plan_covers_every_output_and_word_once(m, k, n):
    kw = bitpack.packed_len(k)
    plan = kmm.bw_plan(m, n, kw)
    assert plan.mt == (1 if m == 1 else 2 if m == 2 else 4)
    gx, gy = plan.grid
    outs = [o for bx in range(gx) for by in range(gy)
            for o in plan.outputs(bx, by)]
    assert sorted(outs) == [(i, j) for i in range(m) for j in range(n)]
    assert len(outs) == len(set(outs))
    # each (word, bit) of K is read by exactly one lane, in 4-bit shares
    shares = [(word, bit + i) for lane in range(32)
              for word, bit in plan.lane_words(lane) for i in range(4)]
    assert sorted(shares) == [(wd, b) for wd in range(kw) for b in range(32)]
    # at the LM's decode shapes no row is wasted and N = 128 is 32 blocks
    if m in (1, 2, 4) and (k, n) in CS.BW_CALLS:
        assert gy == 1 and plan.mt == m and gx == n // 4 >= 32


def test_bw_mirror_matches_cuda_constants():
    src, c = _consts("binary_weight_matmul.cu")
    assert c["BW_NW"] == kmm.BW_NW and c["BW_KV"] == kmm.BW_KV
    assert "const int mt = M <= 1 ? 1 : M == 2 ? 2 : 4;" in src
    assert ("const dim3 grid((N + BW_NW - 1) / BW_NW, (M + mt - 1) / mt);"
            in src)
    assert "__launch_bounds__(32)" in src
    assert "__shared__" not in src and "__syncthreads" not in src


# ------------------------------------------------ emulation of K5 vpu

def _popc(x):
    return bitpack.popcount32(torch.from_numpy(x)).numpy()


def _xor_popc(frows, src, base, units, vec):
    """The kernel's xor_popc over the listed units (offset of each unit
    into src): (rows, VP) sums of popc(x XOR w), through two carry-save
    full adders per 16-byte unit when vec == 4."""
    rows = frows.shape[0]
    dis = np.zeros((rows, len(base)), np.int64)
    for j, b in enumerate(base):
        ones = np.zeros(rows, np.int64)
        twos = np.zeros(rows, np.int64)
        for u, off in units:
            x = src[b + off:b + off + vec]
            d = frows[:, u * vec:(u + 1) * vec] ^ x
            if vec == 4:
                c1 = (ones & d[:, 0]) | (ones & d[:, 1]) | (d[:, 0] & d[:, 1])
                s1 = ones ^ d[:, 0] ^ d[:, 1]
                c2 = (s1 & d[:, 2]) | (s1 & d[:, 3]) | (d[:, 2] & d[:, 3])
                ones = s1 ^ d[:, 2] ^ d[:, 3]
                twos += _popc(c1) + _popc(c2)
            else:
                dis[:, j] += _popc(d[:, 0])
        dis[:, j] += _popc(ones) + 2 * twos
    return dis


def _unit_offsets(u0, u1, nrow, src_row, vec):
    """The kernel's walk of units u0 .. u1-1 through the tap rows."""
    dy, r = 0, u0
    while r >= nrow:
        r -= nrow
        dy += 1
    off, out = dy * src_row + r * vec, []
    for u in range(u0, u1):
        out.append((u, off))
        off += vec
        r += 1
        if r == nrow:
            r = 0
            off += src_row - nrow * vec
    return out


def _sums(frows, src, pos, groups, npos, nv, nrow, src_row, vec):
    """Whole XOR-popcount sums (32 groups x rows, positions) of one pass,
    gathered over the warp items and K slices as run_units does."""
    nb = -(-npos // 4)
    pos = np.concatenate([pos, np.zeros(4 * nb - npos, np.int64)])
    frows = np.concatenate([frows, np.zeros(
        (32 * groups - frows.shape[0], frows.shape[1]), np.int64)])
    tot = np.zeros((32 * groups, 4 * nb), np.int64)
    for _, _, pb, grp, u0, u1 in vpu_items(groups, nb, nv):
        tot[32 * grp:32 * grp + 32, 4 * pb:4 * pb + 4] += _xor_popc(
            frows[32 * grp:32 * grp + 32], src, pos[4 * pb:4 * pb + 4],
            _unit_offsets(u0, u1, nrow, src_row, vec), vec)
    return tot[:, :npos]


def emulate_vpu_pair(a_words, wa, wb, thr, *, fa, fb, pool, th, tw, ka, kb):
    """K5 vpu's arithmetic, cluster rank by rank and tile by tile."""
    n, h, w, cwa = a_words.shape
    oa, la = wa.shape
    ob, lb = wb.shape
    oaw, pf = oa // 32, 2 if pool else 1
    vec = 4 if cwa % 4 == 0 and oaw % 4 == 0 else 1
    ho, wo = h // pf, w // pf
    mr = kfused.vpu_pass_rows(th, tw, **_geom(32 * cwa, oa, fa, fb, pool))
    _, oa_rng, ob_rng = kfused.mxu_split(oa, ob)
    ha, wa_ = pf * th + fb - 1, pf * tw + fb - 1
    rx, cx = ha + fa - 1, wa_ + fa - 1
    x = a_words.astype(np.int64) & 0xFFFFFFFF
    npad_a, npad_b = la * 32 - ka, lb * 32 - kb
    out = np.zeros((n, ho, wo, ob), np.int8)
    for img in range(n):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                ay0, ax0 = oy0 * pf - fb // 2, ox0 * pf - fb // 2
                iy0, ix0 = ay0 - fa // 2, ax0 - fa // 2
                xs = np.zeros((rx, cx, cwa), np.int64)
                for y in range(rx):
                    for xx in range(cx):
                        if 0 <= iy0 + y < h and 0 <= ix0 + xx < w:
                            xs[y, xx] = x[img, iy0 + y, ix0 + xx]
                live = np.array([0 <= ay0 + y < h and 0 <= ax0 + xx < w
                                 for y in range(ha) for xx in range(wa_)])
                pos_a = np.array([(y * cx + xx) * cwa for y in range(ha)
                                  for xx in range(wa_)])
                amap = np.zeros((ha * wa_, oaw), np.int64)
                for a0, a1 in oa_rng:
                    for r0 in range(0, a1 - a0, mr):
                        rows = min(mr, a1 - a0 - r0)
                        ch = np.arange(a0 + r0, a0 + r0 + rows)
                        dis = _sums(wa[ch].astype(np.int64) & 0xFFFFFFFF,
                                    xs.ravel(), pos_a, rows // 32, ha * wa_,
                                    la // vec, fa * cwa // vec, cx * cwa,
                                    vec)
                        y = 32 * la - npad_a - dis
                        bits = (y >= thr["thr_a_c"][ch, None]) \
                            != thr["thr_a_flip"][ch, None]
                        bits &= live[None, :]
                        for i, o in enumerate(ch):
                            amap[:, o // 32] |= bits[i].astype(np.int64) \
                                << (o % 32)
                pos_b = np.array([((qy * pf + s // pf) * wa_ + qx * pf
                                   + s % pf) * oaw for qy in range(th)
                                  for qx in range(tw) for s in range(pf * pf)])
                for b0, b1 in ob_rng:
                    for r0 in range(b0, b1, mr):
                        rows = min(mr, b1 - r0)
                        ch = np.arange(r0, r0 + rows)
                        dis = _sums(wb[ch].astype(np.int64) & 0xFFFFFFFF,
                                    amap.ravel(), pos_b, -(-rows // 32),
                                    th * tw * pf * pf, lb // vec,
                                    fb * oaw // vec, wa_ * oaw, vec)[:rows]
                        y = 32 * lb - npad_b - dis
                        flip = thr["thr_b_flip"][ch, None]
                        bits = (y >= thr["thr_b_c"][ch, None]) != flip
                        bits = bits.reshape(rows, th * tw, pf * pf)
                        pooled = np.where(flip, bits.all(-1), bits.any(-1))
                        for q in range(th * tw):
                            oy, ox = oy0 + q // tw, ox0 + q % tw
                            if oy < ho and ox < wo:
                                out[img, oy, ox, ch] = pooled[:, q]
    return out


# (n, h, w, c, oa, ob, fa, fb, pool, tile): a Table 2 layout at a small
# image (CwA 4, OA/32 8: 16-byte units, a cluster of 8, K split over
# warps), a cluster of 2 with a ragged OB share and 4-byte units, 5x5
# filters, unpooled, a ragged tile grid, a cluster of 3, and one rank
# whose shares take several passes (OA = 352: 6 passes, OB = 100: 2)
VPU_EMU = [(1, 4, 4, 128, 256, 256, 3, 3, True, (1, 2)),
           (1, 4, 4, 128, 256, 200, 3, 3, True, (2, 2)),
           (2, 6, 6, 64, 64, 40, 3, 3, True, (1, 1)),
           (1, 6, 4, 32, 32, 40, 5, 3, False, (4, 4)),
           (1, 6, 6, 32, 96, 40, 3, 5, True, (2, 2)),
           (1, 4, 4, 32, 352, 100, 3, 3, True, (1, 1))]


@pytest.mark.parametrize("n,h,w,c,oa,ob,fa,fb,pool,tile", VPU_EMU)
def test_vpu_emulation_matches_jax_vpu(n, h, w, c, oa, ob, fa, fb, pool,
                                       tile):
    rng = np.random.default_rng(h * 1000 + oa + ob)
    a = rng.integers(0, 2, (n, h, w, c)).astype(np.int8)
    wa = rng.choice([-1.0, 1.0], (oa, fa, fa, c)).astype(np.float32)
    wb = rng.choice([-1.0, 1.0], (ob, fb, fb, oa)).astype(np.float32)
    ka, kb = fa * fa * c, fb * fb * oa
    thr = dict(thr_a_c=rng.integers(ka // 3, 2 * ka // 3, oa).astype(
                   np.float32),
               thr_a_flip=rng.integers(0, 2, oa).astype(bool),
               thr_b_c=rng.integers(kb // 3, 2 * kb // 3, ob).astype(
                   np.float32),
               thr_b_flip=rng.integers(0, 2, ob).astype(bool))
    wa_words = kconv.pack_conv_weights(torch.from_numpy(wa)).numpy()
    wb_words = kconv.pack_conv_weights(torch.from_numpy(wb)).numpy()
    a_words = bitpack.pack_bits(torch.from_numpy(a)).numpy()
    want = np.asarray(jops.xnor_conv2d_pair(
        jnp.asarray(a), jnp.asarray(wa_words), jnp.asarray(wb_words),
        ka=ka, kb=kb, fha=fa, fwa=fa, fhb=fb, fwb=fb, pool_b=pool,
        path="vpu", **{k: jnp.asarray(v) for k, v in thr.items()}))
    got = emulate_vpu_pair(a_words, wa_words, wb_words, thr, fa=fa, fb=fb,
                           pool=pool, th=tile[0], tw=tile[1], ka=ka, kb=kb)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1                       # both bits occur


# ------------------------------------------------ emulation of K6

def emulate_k6(a, w_words, scale=None):
    """K6's float32 arithmetic: per warp of 4 columns and a row tile, each
    lane adds its 4 products of each 128-element step in order, then the
    reduce-scatter butterfly adds the lanes' values in the kernel's order;
    the owner lane multiplies by the scale."""
    m, kp = a.shape
    n, kw = w_words.shape
    plan = kmm.bw_plan(m, n, kw)
    mt, nv = plan.mt, plan.mt * kmm.BW_NW
    a16 = torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()
    bits = bitpack.unpack_bits(torch.from_numpy(w_words)).numpy()
    sign = np.where(bits != 0, np.float32(1), np.float32(-1))
    out = np.zeros((m, n), np.float32)
    lanes = np.arange(32)
    gx, gy = plan.grid
    for bx in range(gx):
        for by in range(gy):
            acc = np.zeros((32, nv), np.float32)
            for lane in range(32):
                for word, bit in plan.lane_words(lane):
                    for i in range(kmm.BW_KV):
                        e = 32 * word + bit + i
                        for r in range(mt):
                            row = by * mt + r
                            xv = a16[row, e] if row < m else np.float32(0)
                            for cc in range(kmm.BW_NW):
                                col = bx * kmm.BW_NW + cc
                                sg = sign[col, e] if col < n else \
                                    np.float32(-1)
                                acc[lane, r * kmm.BW_NW + cc] = np.float32(
                                    acc[lane, r * kmm.BW_NW + cc] + xv * sg)
            v = acc.copy()
            for s in range(5):
                o = 16 >> s
                partner = lanes ^ o
                if (nv >> s) >= 2:
                    half = (nv >> s) // 2
                    up = (lanes & o) != 0
                    lo, hi = v[:, :half], v[:, half:2 * half]
                    send = np.where(up[:, None], lo, hi)
                    keep = np.where(up[:, None], hi, lo)
                    v = (keep + send[partner]).astype(np.float32)
                else:
                    v = (v[:, :1] + v[partner, :1]).astype(np.float32)
            for lane in range(0, 32, 32 // nv):
                idx = sum(((lane >> (4 - s)) & 1) * ((nv >> s) // 2)
                          for s in range(nv.bit_length() - 1))
                row = by * mt + idx // kmm.BW_NW
                col = bx * kmm.BW_NW + idx % kmm.BW_NW
                if row < m and col < n:
                    val = v[lane, 0]
                    out[row, col] = val if scale is None else \
                        np.float32(val * scale[col])
    return out


@pytest.mark.parametrize("m,k,n", [(4, 128, 128), (4, 256, 128), (1, 128, 8),
                                   (2, 64, 12), (5, 40, 33), (16, 128, 20)])
@pytest.mark.parametrize("kind", ["pm1", "float32", "bfloat16"])
def test_k6_emulation_matches_jax(m, k, n, kind):
    rng = np.random.default_rng(m * 100 + k + n)
    w = bitpack.pack_pm1(torch.from_numpy(
        rng.normal(size=(n, k)).astype(np.float32))).numpy()
    kp = w.shape[1] * 32
    scale = None
    if kind == "pm1":
        a = rng.choice([-1.0, 1.0], (m, k)).astype(np.float32)
    else:
        a = rng.normal(size=(m, k)).astype(np.float32)
        scale = (rng.random(n) + 0.5).astype(np.float32)
    dt = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    want = np.asarray(jops.binary_weight_matmul(
        jnp.asarray(a, dt), jnp.asarray(w), k=k,
        scale=None if scale is None else jnp.asarray(scale)).astype(
            jnp.float32))
    got = emulate_k6(np.pad(a, ((0, 0), (0, kp - k))), w, scale)
    if kind == "bfloat16":
        got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    if kind == "pm1":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[kind])
