"""The port's fused conv pair (K5 path) and layer planner against the JAX
reference, on the same numpy inputs.

* ``ops.xnor_conv2d_pair`` on CPU tensors (the plain version for every
  path) against the reference's ``ops.xnor_conv2d_pair`` on "xla" and on
  its Pallas kernels "vpu" / "mxu" in interpret mode, at small widths:
  pool on and off, a ragged tile grid, 3×3 and 5×5 filters, ragged OB.
  Bits are held to exact equality.
* ``forward_packed(conv_fusion=True)`` at full Table 2 width against the
  reference's fused forward on path "xla": logits allclose (rtol = atol =
  1e-5, the bar of tests/test_torch_bcnn.py) with the same argmax; the
  fused groups bit-exact against the sequential fold for both strategies.
* ``plan_layer_groups``, ``default_group_tiles``, ``plan_to_dict`` and
  ``geometry_fingerprint`` against the reference's.
* The Python mirror of the mxu kernel's launcher: its cluster size and
  channel split (``mxu_split``), its shared memory (``halo_scratch``,
  ``mxu_pass_rows``) against the .cu's constants, every tile the previous
  single-block kernel allowed still legal, and the Table 2 pairs' tile
  candidates and default tiles unchanged.

The CUDA kernel K5 itself runs only on the card (``chip_smoke.py``); here
its wrappers must refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro.core import execution_plan as jxp
from repro.kernels import ops as jops
from repro_torch.core import bcnn, bconv, bitpack, execution_plan as xp
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import xnor_conv as kconv
from repro_torch.kernels import xnor_conv_fused as kfused

PATHS = ["xla", "vpu", "mxu"]
# (n, h, w, c, oa, ob, fa, fb, pool, tiles)
PAIRS = [
    (2, 8, 8, 32, 32, 32, 3, 3, True, None),
    (2, 8, 8, 32, 32, 32, 3, 3, False, (4, 4)),
    (2, 10, 6, 32, 32, 32, 3, 3, False, (4, 4)),    # ragged tile grid
    (1, 10, 6, 32, 32, 32, 5, 5, True, (4, 4)),     # 5x5, ragged pooled
    (2, 6, 6, 64, 32, 40, 5, 3, True, (2, 2)),      # ragged OB
]


def _pair_inputs(seed, n, h, w, c, oa, ob, fa, fb):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (n, h, w, c)).astype(np.int8)
    wa = rng.choice([-1.0, 1.0], (oa, fa, fa, c)).astype(np.float32)
    wb = rng.choice([-1.0, 1.0], (ob, fb, fb, oa)).astype(np.float32)
    ka, kb = fa * fa * c, fb * fb * oa
    thr = dict(thr_a_c=rng.integers(0, ka + 1, oa).astype(np.float32),
               thr_a_flip=rng.integers(0, 2, oa).astype(bool),
               thr_b_c=rng.integers(0, kb + 1, ob).astype(np.float32),
               thr_b_flip=rng.integers(0, 2, ob).astype(bool))
    return a, wa, wb, ka, kb, thr


@pytest.mark.parametrize("n,h,w,c,oa,ob,fa,fb,pool,tiles", PAIRS)
@pytest.mark.parametrize("path", PATHS)
def test_pair_matches_jax(path, n, h, w, c, oa, ob, fa, fb, pool, tiles):
    a, wa, wb, ka, kb, thr = _pair_inputs(h * 100 + c + ob, n, h, w, c, oa,
                                          ob, fa, fb)
    wa_words = kconv.pack_conv_weights(torch.from_numpy(wa))
    wb_words = kconv.pack_conv_weights(torch.from_numpy(wb))
    geo = dict(ka=ka, kb=kb, fha=fa, fwa=fa, fhb=fb, fwb=fb, pool_b=pool)
    want = np.asarray(jops.xnor_conv2d_pair(
        jnp.asarray(a), jnp.asarray(wa_words.numpy()),
        jnp.asarray(wb_words.numpy()), path=path, tiles=tiles,
        **{k: jnp.asarray(v) for k, v in thr.items()}, **geo))
    got = ops.xnor_conv2d_pair(
        torch.from_numpy(a), wa_words, wb_words, path=path, tiles=tiles,
        **{k: torch.from_numpy(v) for k, v in thr.items()}, **geo)
    assert got.dtype == torch.int8 and str(want.dtype) == "int8"
    assert got.shape == want.shape == (n, h // (1 + pool), w // (1 + pool),
                                       ob)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair_ref_is_two_convs_and_the_pool():
    """The plain pair equals two ``ops.xnor_conv2d`` calls and the
    flip-aware pool of ``bconv.apply_packed``."""
    a, wa, wb, ka, kb, thr = _pair_inputs(5, 2, 8, 8, 32, 32, 40, 3, 3)
    t = {k: torch.from_numpy(v) for k, v in thr.items()}
    wa_words = kconv.pack_conv_weights(torch.from_numpy(wa))
    wb_words = kconv.pack_conv_weights(torch.from_numpy(wb))
    fpa = bconv.BConvPacked(
        w_words=bitpack.pack_pm1(torch.from_numpy(wa).reshape(32, -1)),
        thr=bconv.NBThreshold(t["thr_a_c"], t["thr_a_flip"]), k=ka,
        w_words_hw=wa_words)
    fpb = bconv.BConvPacked(
        w_words=bitpack.pack_pm1(torch.from_numpy(wb).reshape(40, -1)),
        thr=bconv.NBThreshold(t["thr_b_c"], t["thr_b_flip"]), k=kb,
        w_words_hw=wb_words)
    for strategy in ("direct", "im2col"):
        seq = bconv.apply_packed(fpb, bconv.apply_packed(
            fpa, torch.from_numpy(a), path="xla", strategy=strategy),
            maxpool=True, path="xla", strategy=strategy)
        got = bconv.apply_packed_pair(fpa, fpb, torch.from_numpy(a),
                                      maxpool_b=True, path="xla")
        assert torch.equal(got, seq)
    direct = ref.xnor_conv2d_pair_ref(
        torch.from_numpy(a), bitpack.encode_pm1(torch.from_numpy(wa)),
        bitpack.encode_pm1(torch.from_numpy(wb)), pool_b=True, **t)
    assert torch.equal(direct, seq)


def test_pair_rejects_bad_arguments():
    a, wa, wb, ka, kb, thr = _pair_inputs(1, 1, 4, 4, 32, 32, 32, 3, 3)
    t = {k: torch.from_numpy(v) for k, v in thr.items()}
    wa_words = kconv.pack_conv_weights(torch.from_numpy(wa))
    wb_words = kconv.pack_conv_weights(torch.from_numpy(wb))
    geo = dict(ka=ka, kb=kb, fha=3, fwa=3, fhb=3, fwb=3, **t)
    with pytest.raises(ValueError, match="odd"):
        ops.xnor_conv2d_pair(torch.from_numpy(a), wa_words, wb_words,
                             **{**geo, "fha": 2})
    with pytest.raises(ValueError, match="C % 32"):
        ops.xnor_conv2d_pair(torch.from_numpy(a[..., :31]), wa_words,
                             wb_words, path="vpu", **geo)
    with pytest.raises(ValueError, match="unknown kernel path"):
        ops.xnor_conv2d_pair(torch.from_numpy(a), wa_words, wb_words,
                             path="tpu", **geo)
    fpa = bconv.BConvPacked(w_words=wa_words, thr=None, k=ka,
                            w_words_hw=None)
    with pytest.raises(ValueError, match="per-position"):
        bconv.apply_packed_pair(fpa, fpa, torch.from_numpy(a))
    fpa = fpa._replace(w_words_hw=wa_words)
    with pytest.raises(ValueError, match="32-aligned"):
        bconv.apply_packed_pair(fpa, fpa, torch.from_numpy(a[..., :31]))


@pytest.mark.parametrize("fn", [kfused.xnor_conv2d_pair_vpu,
                                kfused.xnor_conv2d_pair_mxu])
def test_pair_kernel_wrappers_refuse_cpu_tensors(fn):
    """K5's wrappers launch on CUDA tensors or raise; a refused call
    counts no launch."""
    before = fn.launches
    a = torch.zeros((1, 4, 4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(a, torch.zeros((32, 9), dtype=torch.int32),
           torch.zeros((32, 9), dtype=torch.int32), ka=288, kb=288, fha=3,
           fwa=3, fhb=3, fwb=3, pool=False, thr_a_c=None, thr_a_flip=None,
           thr_b_c=None, thr_b_flip=None, th=1, tw=1)
    assert fn.launches == before
    assert fn.__name__ in _build.SIGNATURES


# ------------------------------------------------------- full-width forward

def jax_params(p) -> jbcnn.BCNNParams:
    def conv(cls, q):
        return cls(*[jnp.asarray(getattr(q, f)) for f in cls._fields])
    return jbcnn.BCNNParams(
        conv1=conv(jbconv.FpConvParams, p.conv1),
        convs=tuple(conv(jbconv.BConvParams, q) for q in p.convs),
        fcs=tuple(conv(jblinear.BLinearParams, q) for q in p.fcs))


@pytest.fixture(scope="module")
def nets():
    npp = bcnn.numpy_params(0)
    return (jbcnn.fold_model(jax_params(npp)),
            bcnn.fold_model(bcnn.params_from_numpy(npp)))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)


def test_fused_forward_matches_jax_fused_forward(nets, images):
    jpk, tpk = nets
    want = np.asarray(jbcnn.forward_packed(jpk, jnp.asarray(images),
                                           path="xla", conv_fusion=True))
    got = bcnn.forward_packed(tpk, torch.from_numpy(images), path="xla",
                              conv_fusion=True).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    unfused = bcnn.forward_packed(tpk, torch.from_numpy(images),
                                  path="xla").numpy()
    np.testing.assert_array_equal(got, unfused)


@pytest.mark.parametrize("strategy", ["direct", "im2col"])
def test_fused_groups_bit_exact_vs_sequential(nets, images, strategy):
    _, tpk = nets
    plan = xp.build_plan(tpk, device="cpu", conv_strategy=strategy)
    h = torch.from_numpy(images)
    for idx in range(2):
        h = bcnn.apply_packed_layer(tpk, idx, h, plan=plan)
    for pair in ((2, 3), (4, 5)):
        seq = h
        for idx in pair:
            seq = bcnn.apply_packed_layer(tpk, idx, seq, plan=plan)
        fused = bcnn.apply_packed_group(tpk, pair, h, path="xla")
        assert fused.dtype == torch.int8 and torch.equal(fused, seq)
        h = seq


def test_apply_packed_group_rejects_bad_pairs(nets):
    _, tpk = nets
    a = torch.zeros((1, 16, 16, 128), dtype=torch.int8)
    for bad in [(2, 4), (0, 1), (5, 6), (3, 2)]:
        with pytest.raises(ValueError, match="fusible"):
            bcnn.apply_packed_group(tpk, bad, a, path="xla")


# --------------------------------------------------------- planner and plan

def test_plan_layer_groups_match_jax_every_window():
    for start in range(bcnn.N_LAYERS):
        for stop in range(start, bcnn.N_LAYERS + 1):
            for fusion in (None, False, True):
                assert bcnn.plan_layer_groups(
                    start, stop, conv_fusion=fusion) == \
                    jbcnn.plan_layer_groups(start, stop, conv_fusion=fusion)
    assert bcnn.plan_layer_groups(conv_fusion=True) == \
        ((0,), (1,), (2, 3), (4, 5), (6,), (7,), (8,))


def test_default_tiles_legal_and_differ_from_reference(nets):
    """Tiles never change bits, so the port picks its own: the largest
    tile whose shared memory fits and that leaves >= MIN_TILES tiles per
    image. The reference's VMEM rule gives (4, 8) and (4, 4)."""
    jpk, tpk = nets
    groups = bcnn.plan_layer_groups(conv_fusion=True)
    port = xp.default_group_tiles(tpk, groups)
    assert port == ((2, 1, 2), (4, 1, 1))
    assert jxp.default_group_tiles(jpk, groups) == ((2, 4, 8), (4, 4, 4))
    for i, th, tw in port:
        pg = xp.pair_geometry(tpk, i)
        assert kfused.tile_fits(th, tw, **pg["geom"])
        assert -(-pg["ho"] // th) * -(-pg["wo"] // tw) >= min(
            kfused.MIN_TILES, pg["ho"] * pg["wo"])
        for v in kfused.VARIANTS:
            assert kfused.halo_scratch(th, tw, variant=v, **pg["geom"]) \
                <= kfused.SMEM_PER_BLOCK
    plan = xp.build_plan(tpk, device="cpu", conv_fusion=True)
    assert plan.group_tiles == port and plan.tiles_for(2) == (1, 2)
    assert plan.tiles_for(1) is None


def test_pick_tiles_shrinks_to_fit_shared_memory():
    geom = dict(pf=2, fha=3, fwa=3, cwa=32, fhb=3, fwb=3, oa=1024)
    assert not kfused.tile_fits(8, 8, **geom)
    assert kfused.pick_tiles(64, 64, **geom) == (4, 8)
    # (4, 8): input halo 12 x 20 x 32 words, A bit map 10 x 18 x 32 words
    # and the vpu's 128 filter rows at a stride of 3*3*32 | 1 words
    assert kfused.halo_scratch(4, 8, variant="vpu", **geom) == \
        4 * (12 * 20 * 32 + 10 * 18 * 32 + 128 * 289)
    # mxu: the same halo and map, then 64 rows of 3*3*32 = 288 words of
    # each conv's filters (of conv A's 1024 / 8 = 128 per rank), then the
    # static split-K tiles and mbarriers
    assert kfused.halo_scratch(4, 8, variant="mxu", **geom) == \
        4 * (12 * 20 * 32 + 10 * 18 * 32 + 64 * 288 + 64 * 288) \
        + kfused.MXU_STATIC_BYTES
    with pytest.raises(ValueError, match="variant"):
        kfused.halo_scratch(1, 1, variant="xla", **geom)


# ------------------------------------------ the mxu kernel's cluster mirror

@pytest.mark.parametrize("words,c", [(1, 1), (2, 2), (3, 3), (8, 8), (16, 8),
                                     (32, 8), (5, 5), (12, 6), (14, 7)])
@pytest.mark.parametrize("ob", [40, 256, 5])
def test_mxu_split_covers_every_channel_once(words, c, ob):
    """C is the largest divisor of OA/32 up to 8; the OA ranges are whole
    channel words, the OB ranges ceil-split; together each covers every
    channel exactly once, in order."""
    oa = 32 * words
    got_c, oa_ranges, ob_ranges = kfused.mxu_split(oa, ob)
    assert got_c == c and len(oa_ranges) == len(ob_ranges) == c
    for ranges, total in ((oa_ranges, oa), (ob_ranges, ob)):
        covered = [ch for lo, hi in ranges for ch in range(lo, hi)]
        assert covered == list(range(total))
    assert all((hi - lo) == oa // c and lo % 32 == 0 for lo, hi in oa_ranges)
    sizes = [hi - lo for lo, hi in ob_ranges]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == -(-ob // c)
    with pytest.raises(ValueError, match="multiple of 32"):
        kfused.mxu_split(oa + 16, ob)


def test_mxu_split_uneven_ob_shares():
    """OA = 96 (C = 3) and OB = 40: shares of 14, 13 and 13 channels;
    OA = 64 (C = 2): 20 and 20, neither a whole m16 tile."""
    assert kfused.mxu_split(96, 40) == (3, [(0, 32), (32, 64), (64, 96)],
                                        [(0, 14), (14, 27), (27, 40)])
    assert kfused.mxu_split(64, 40) == (2, [(0, 32), (32, 64)],
                                        [(0, 20), (20, 40)])


@pytest.mark.parametrize("tile,geom,want", [
    # CONV-3/4 at (1, 2): halo 6 x 8 x 4 words, map 4 x 6 x 8 words; 32
    # conv A rows of 36 words, 64 conv B rows of 72
    ((1, 2), dict(pf=2, fha=3, fwa=3, cwa=4, fhb=3, fwb=3, oa=256),
     4 * (6 * 8 * 4 + 4 * 6 * 8 + 32 * 36 + 64 * 72)),
    # CONV-5/6 at (1, 1): halo 6 x 6 x 8, map 4 x 4 x 16; 64 rows of 72
    # words and 64 rows of 144
    ((1, 1), dict(pf=2, fha=3, fwa=3, cwa=8, fhb=3, fwb=3, oa=512),
     4 * (6 * 6 * 8 + 4 * 4 * 16 + 64 * 72 + 64 * 144)),
])
def test_mxu_halo_scratch_bytes_at_table2_pairs(tile, geom, want):
    assert kfused.halo_scratch(*tile, variant="mxu", **geom) == \
        want + kfused.MXU_STATIC_BYTES
    assert kfused.MXU_STATIC_BYTES == 8 * 16 * 8 * 4 + 2 * 8


def test_mxu_pass_rows_halve_until_the_block_fits():
    """64 filter rows per pass where they fit; a geometry whose 64 rows
    overflow the block takes 32 (16 at the least), as the launcher does."""
    geom = dict(pf=2, fha=5, fwa=5, cwa=16, fhb=5, fwb=5, oa=512)
    ha = wa = 2 * 4 + 4
    words = (ha + 4) * (wa + 4) * 16 + ha * wa * 16
    la = lb = 25 * 16
    assert kfused.mxu_pass_rows(words, oa=512, la=la, lb=lb) == 32
    assert kfused.halo_scratch(4, 4, variant="mxu", **geom) == 4 * (
        words + 32 * la + 32 * lb) + kfused.MXU_STATIC_BYTES
    assert kfused.tile_fits(4, 4, **geom)
    assert kfused.mxu_pass_rows(100, oa=256, la=36, lb=72) == 64


def test_mxu_mirror_matches_cuda_constants():
    """The constants halo_scratch and mxu_split mirror, read from the .cu:
    256 threads, MR = 64 rows per pass, clusters of at most 8, the 227 KB
    limit, and MxuStatic = one int32 m16n8 tile per warp and two mbarriers;
    the launcher stages ra * LA + mr * LB filter words beside the halo. The
    cluster bound and the limit live in csrc/bits.cuh, which K5 shares
    with K2 and K4."""
    import re
    src = (_build.CSRC / "xnor_conv_fused.cu").read_text()
    assert '#include "bits.cuh"' in src
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);",
                             src + (_build.CSRC / "bits.cuh").read_text()))
    assert consts["THREADS"] == "256" and consts["MR"] == str(kfused.MXU_ROWS)
    assert consts["MAX_CLUSTER"] == str(kfused.MXU_MAX_CLUSTER)
    assert consts["SMEM_LIMIT"] == str(kfused.SMEM_PER_BLOCK)
    static = re.search(r"struct MxuStatic \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+) (\w+)\[([^\]]+)\];", static) == [
        ("int", "red", "WARPS * 128"), ("uint64_t", "bar", "2")]
    assert kfused.MXU_STATIC_BYTES == 4 * (256 // 32) * 128 + 8 * 2
    assert "static_cast<size_t>(ra) * LA +" in src
    assert "static_cast<size_t>(mr) * LB" in src


def _old_mxu_scratch(th, tw, *, pf, fha, fwa, cwa, fhb, fwb, oa):
    """The single-block mxu kernel's shared memory (halo, map and its
    20,480 static bytes of int8 k-slabs and accumulator tiles)."""
    ha, wa = pf * th + fhb - 1, pf * tw + fwb - 1
    return 4 * ((ha + fha - 1) * (wa + fwa - 1) * cwa
                + ha * wa * (oa // 32)) + 20480


def test_mxu_keeps_every_tile_the_old_kernel_allowed():
    n_legal = 0
    for pf in (1, 2):
        for fa, fb in ((3, 3), (5, 5), (5, 3), (1, 1)):
            for cwa in (1, 2, 4, 8, 16, 32):
                for oa in (32, 96, 256, 512, 1024, 1440, 2048):
                    geom = dict(pf=pf, fha=fa, fwa=fa, cwa=cwa, fhb=fb,
                                fwb=fb, oa=oa)
                    for th in (1, 2, 4, 8):
                        for tw in (1, 2, 4, 8):
                            old = (kfused.halo_scratch(
                                th, tw, variant="vpu", **geom)
                                <= kfused.SMEM_PER_BLOCK
                                and _old_mxu_scratch(th, tw, **geom)
                                <= kfused.SMEM_PER_BLOCK)
                            n_legal += old
                            assert not old or kfused.tile_fits(th, tw,
                                                               **geom), geom
    assert n_legal > 1000


@pytest.mark.parametrize("pair,hw,geom,tiles,default", [
    (2, 8, dict(pf=2, fha=3, fwa=3, cwa=4, fhb=3, fwb=3, oa=256),
     [(th, tw) for th in (1, 2, 4, 8) for tw in (1, 2, 4, 8)], (1, 2)),
    (4, 4, dict(pf=2, fha=3, fwa=3, cwa=8, fhb=3, fwb=3, oa=512),
     [(th, tw) for th in (1, 2, 4) for tw in (1, 2, 4)], (1, 1)),
])
def test_table2_tile_candidates_and_default_unchanged(nets, pair, hw, geom,
                                                      tiles, default):
    """CONV-3/4: 16 tiles from (1, 1) to (8, 8); CONV-5/6: 9 tiles from
    (1, 1) to (4, 4); the defaults (1, 2) and (1, 1)."""
    from repro_torch.kernels import autotune as at
    _, tpk = nets
    pg = xp.pair_geometry(tpk, pair)
    assert pg["geom"] == geom and pg["ho"] == pg["wo"] == hw
    assert list(at.tile_candidates(hw, hw, **geom)) == tiles
    assert kfused.pick_tiles(hw, hw, **geom) == default


def test_plan_dict_roundtrip_with_reference_keys(nets):
    jpk, tpk = nets
    plan = xp.build_plan(tpk, device="cpu", conv_fusion=True)
    d = xp.plan_to_dict(plan)
    assert xp.plan_from_dict(d) == plan
    jd = jxp.plan_to_dict(jxp.build_plan(jpk, conv_fusion=True))
    assert sorted(d) == sorted(jd)
    assert xp.plan_from_dict(jd).group_tiles == ((2, 4, 8), (4, 4, 4))
    assert d["group_tiles"] == [[2, 1, 2], [4, 1, 1]]


def test_geometry_fingerprint_equals_reference(nets):
    jpk, tpk = nets
    assert xp.geometry_fingerprint(tpk) == jxp.geometry_fingerprint(jpk)
    key = xp.plan_cache_key(tpk, "cpu")
    assert key == {"backend": "cpu", "device_kind": "cpu",
                   "geometry": jxp.geometry_fingerprint(jpk)}
    assert xp.plan_key_fingerprint(key) == jxp.plan_key_fingerprint(key)
    other = bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))
    assert xp.geometry_fingerprint(other) == xp.geometry_fingerprint(tpk)
