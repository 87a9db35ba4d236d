"""Wrappers of the CUDA fused conv-pair kernel K5 (``csrc/xnor_conv_fused.cu``)
and the tile rule it shares with the tuner.

Both variants launch a thread-block cluster per (image, tile):
``mxu_split`` gives the cluster size C (the largest divisor of OA/32 up
to 8) and each rank's channels. Rank r computes conv A for its OA/C
channels over the whole halo, the ranks share the A bit map through
distributed shared memory, and rank r computes conv B for its ceil-split
share of OB. A cluster shape the card cannot schedule makes the launch
raise; there is no other kernel to fall back to.

* ``xnor_conv2d_pair_vpu`` replaces ``repro/kernels/xnor_conv_fused.py::
  xnor_conv2d_pair_vpu``: both convs by XNOR + ``__popc`` on the CUDA
  cores, each thread a register block of one filter row (lane = row) by
  ``VPU_POSITIONS`` positions, 16-byte shared-memory loads, the filters,
  CwA and OA/32 of the Table 2 pairs as compile-time constants (other
  geometries run the same kernel with them read at run time). Each rank
  stores its words of the bit map into every rank's map.
* ``xnor_conv2d_pair_mxu`` replaces ``repro/kernels/xnor_conv_fused.py::
  xnor_conv2d_pair_mxu``: both convs as ±1 int8 ``mma.sync`` m16n8k32
  with int32 sums (filter rows on M, positions on N). Each rank copies
  the peers' words of the bit map from their shared memory.

One launch computes conv A → eq. 8 → conv B → eq. 8 → optional flip-aware
2×2 pool; the A-output bit map stays in shared memory. Both take the
unpadded channel-packed input (N, H, W, CwA) int32, the per-position
packed filters (OA, FHa·FWa·CwA) and (OB, FHb·FWb·OA/32) int32
(``xnor_conv.pack_conv_weights``), float32/bool thresholds of shape (OA,)
and (OB,), and a (th, tw) output tile; they return (N, H/pf, W/pf, OB)
int8 bits, launch on the current stream, allocate only their output and
count their launches (``xnor_conv2d_pair_vpu.launches``). The plain
version is ``kernels/ref.py::xnor_conv2d_pair_ref``.

Tiles. A block computes its share of one th × tw tile of the pair's
output; its shared memory holds the input halo, the A bit map over the
halo and the rank's filter rows in passes (vpu: up to ``VPU_ROWS`` rows
of each conv at a bank-conflict-free stride, and position tables; mxu:
up to ``MXU_ROWS`` rows of each conv). ``halo_scratch`` returns those
bytes exactly as the CUDA launchers allocate them, and a tile is legal
when both variants fit the per-block limit. ``pick_tiles`` starts from
the largest power-of-two tile up to (TH, TW) and halves it while it is
illegal or the tile grid of one image is smaller than ``MIN_TILES``: with
the engine's 4 slots that keeps at least 128 tiles in flight, about one
per SM of the H100 (132). Tiles never change bits.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build, launch_count
from repro_torch.kernels.xnor_matmul import check_thresholds, check_words

TH = 8                  # largest tile the rule and the tuner consider
TW = 8
MIN_TILES = 32          # tiles per image the default tile aims for
SMEM_PER_BLOCK = 232448  # H100: opt-in shared memory per block (227 KB)
VARIANTS = ("vpu", "mxu")
# Mirrors of csrc/xnor_conv_fused.cu: the vpu kernel register-blocks VP
# positions per thread, stages up to VR filter rows of each conv per pass
# (halved to 32 until the block fits), and its static shared memory
# (VpuStatic) is one int per (lane, position) of WARPS / 2 = 4 warp units
# for split-K partial sums and two 8-byte mbarriers; the mxu kernel stages
# up to MR filter rows of each conv per pass, as they lie in device memory,
# and its static shared memory (MxuStatic) is one int32 m16n8 tile per warp
# (8 warps) for split-K partial sums and two 8-byte mbarriers. Both run in
# clusters of at most MAX_CLUSTER blocks.
VPU_POSITIONS = 4
VPU_ROWS = 64
VPU_STATIC_BYTES = 4 * 32 * VPU_POSITIONS * 4 + 2 * 8
MXU_ROWS = 64
MXU_MAX_CLUSTER = 8
MXU_STATIC_BYTES = 8 * 16 * 8 * 4 + 2 * 8


def mxu_split(oa: int, ob: int) -> tuple[int, list[tuple[int, int]],
                                        list[tuple[int, int]]]:
    """The cluster of both launchers: (C, conv A channel ranges, conv B
    channel ranges) per rank. C is the largest divisor of OA/32 that is at most
    ``MXU_MAX_CLUSTER``; rank r takes OA channels [r·OA/C, (r+1)·OA/C) (a
    multiple of 32 each) and OB channels [⌈r·OB/C⌉, ⌈(r+1)·OB/C⌉)."""
    if oa % 32 or oa <= 0:
        raise ValueError(f"OA={oa} must be a positive multiple of 32")
    c = MXU_MAX_CLUSTER
    while (oa // 32) % c:
        c -= 1
    return (c, [(r * oa // c, (r + 1) * oa // c) for r in range(c)],
            [(-(-r * ob // c), -(-(r + 1) * ob // c)) for r in range(c)])


def _mxu_bytes(words: int, oa: int, la: int, lb: int, rows: int) -> int:
    rows_a = min(oa // mxu_split(oa, 0)[0], rows)
    return 4 * (words + rows_a * la + rows * lb) + MXU_STATIC_BYTES


def mxu_pass_rows(words: int, *, oa: int, la: int, lb: int) -> int:
    """Filter rows the mxu kernel stages per pass, as its launcher picks
    them: ``MXU_ROWS``, halved down to 16 until the block (``words`` of
    input halo and bit map, the rows of both convs, the static tiles) fits
    ``SMEM_PER_BLOCK``."""
    rows = MXU_ROWS
    while rows > 16 and _mxu_bytes(words, oa, la, lb, rows) > SMEM_PER_BLOCK:
        rows //= 2
    return rows


def vpu_stride(words: int, vec: int) -> int:
    """Word stride of a vpu filter row of ``words`` words, as the kernel
    stages it: with 16-byte loads (vec 4, words a multiple of 4) the row
    as it lies, so one TMA bulk copy brings a conv's rows; else odd (32
    rows in 32 banks)."""
    return words if vec == 4 else words | 1


def _round_vp(x: int) -> int:
    return -(-x // VPU_POSITIONS) * VPU_POSITIONS


def _vpu_layout(th: int, tw: int, *, pf: int, fha: int, fwa: int,
                cwa: int, fhb: int, fwb: int, oa: int) -> dict:
    ha, wa = pf * th + fhb - 1, pf * tw + fwb - 1
    return dict(
        words=(ha + fha - 1) * (wa + fwa - 1) * cwa + ha * wa * (oa // 32),
        rows_a=oa // mxu_split(oa, 0)[0],
        vec=4 if cwa % 4 == 0 and (oa // 32) % 4 == 0 else 1,
        la=fha * fwa * cwa, lb=fhb * fwb * (oa // 32),
        tables=(_round_vp(ha * wa) + _round_vp(th * tw * pf * pf)
                + _round_vp(th * tw)))


def _vpu_bytes(lay: dict, rows: int) -> int:
    return 4 * (lay["words"]
                + min(lay["rows_a"], rows) * vpu_stride(lay["la"], lay["vec"])
                + rows * vpu_stride(lay["lb"], lay["vec"]) + lay["tables"]
                ) + VPU_STATIC_BYTES


def vpu_pass_rows(th: int, tw: int, **geom) -> int:
    """Filter rows the vpu kernel stages per pass, as its launcher picks
    them: ``VPU_ROWS``, halved down to 32 until the block fits
    ``SMEM_PER_BLOCK``. ``geom``: the keyword arguments of
    ``halo_scratch`` other than ``variant``."""
    lay = _vpu_layout(th, tw, **geom)
    rows = VPU_ROWS
    while rows > 32 and _vpu_bytes(lay, rows) > SMEM_PER_BLOCK:
        rows //= 2
    return rows


def halo_scratch(th: int, tw: int, *, pf: int, fha: int, fwa: int,
                 cwa: int, fhb: int, fwb: int, oa: int,
                 variant: str) -> int:
    """Shared-memory bytes one block of ``variant`` allocates for a
    (th, tw) output tile: the input halo (pf·th+FHb+FHa−2) ×
    (pf·tw+FWb+FWa−2) × CwA words and the A bit map (pf·th+FHb−1) ×
    (pf·tw+FWb−1) × OA/32 words, plus

    * vpu: min(OA/C, R) conv A rows and R conv B rows at ``vpu_stride``
      (16-byte loads where CwA and OA/32 are multiples of 4), R from
      ``vpu_pass_rows``; tables of the A-halo
      positions, the conv B positions and the outputs, each rounded up to
      ``VPU_POSITIONS`` ints; and its static shared memory
      (``VPU_STATIC_BYTES``);
    * mxu: min(OA/C, R) conv A rows and R conv B rows as they lie (R from
      ``mxu_pass_rows``) and its static shared memory
      (``MXU_STATIC_BYTES``).

    OB does not enter: a share beyond R streams in passes."""
    ha, wa = pf * th + fhb - 1, pf * tw + fwb - 1
    words = (ha + fha - 1) * (wa + fwa - 1) * cwa + ha * wa * (oa // 32)
    la, lb = fha * fwa * cwa, fhb * fwb * (oa // 32)
    if variant == "vpu":
        geom = dict(pf=pf, fha=fha, fwa=fwa, cwa=cwa, fhb=fhb, fwb=fwb,
                    oa=oa)
        return _vpu_bytes(_vpu_layout(th, tw, **geom),
                          vpu_pass_rows(th, tw, **geom))
    if variant == "mxu":
        return _mxu_bytes(words, oa, la, lb,
                          mxu_pass_rows(words, oa=oa, la=la, lb=lb))
    raise ValueError(f"unknown variant {variant!r}; use one of {VARIANTS}")


def tile_fits(th: int, tw: int, **geom) -> bool:
    """Legal tile: both variants' ``halo_scratch`` fit one block."""
    return all(halo_scratch(th, tw, variant=v, **geom) <= SMEM_PER_BLOCK
               for v in VARIANTS)


def block_for(m: int, default: int) -> int:
    """Largest power of two <= min(m, default) (the reference's
    ``ops._block_for`` with floor 1)."""
    b = 1
    while b * 2 <= min(m, default):
        b *= 2
    return b


def pick_tiles(ho: int, wo: int, **geom) -> tuple[int, int]:
    """Default (th, tw): the largest power-of-two tile up to (TH, TW) that
    is legal (``tile_fits``) and leaves at least ``MIN_TILES`` tiles per
    image, halving the larger dimension first. ``geom``: the keyword
    arguments of ``halo_scratch`` other than ``variant``."""
    th, tw = block_for(ho, TH), block_for(wo, TW)
    while th * tw > 1:
        n_tiles = -(-ho // th) * -(-wo // tw)
        if tile_fits(th, tw, **geom) and n_tiles >= MIN_TILES:
            break
        if th >= tw:
            th //= 2
        else:
            tw //= 2
    return th, tw


def _launch(name, a_words, wa_words, wb_words, *, ka, kb, fha, fwa, fhb, fwb,
            pool, thr_a_c, thr_a_flip, thr_b_c, thr_b_flip, th, tw):
    check_words(a_words, 4, "a_words")
    check_words(wa_words, 2, "wa_words")
    check_words(wb_words, 2, "wb_words")
    n, h, w, cwa = a_words.shape
    oa, la = wa_words.shape
    ob, lb = wb_words.shape
    dev = a_words.device
    if any(f % 2 == 0 for f in (fha, fwa, fhb, fwb)):
        raise ValueError("the fused pair takes odd SAME filters only, got "
                         f"{fha}x{fwa} and {fhb}x{fwb}")
    if oa % bitpack.PACK:
        raise ValueError(f"OA={oa} must be a multiple of 32: conv A's bits "
                         f"are re-packed into channel words")
    if la != fha * fwa * cwa or wa_words.device != dev:
        raise ValueError(f"wa_words {tuple(wa_words.shape)} on "
                         f"{wa_words.device} is not (OA, {fha}·{fwa}·{cwa}) "
                         f"on {dev}")
    if lb != fhb * fwb * (oa // bitpack.PACK) or wb_words.device != dev:
        raise ValueError(f"wb_words {tuple(wb_words.shape)} on "
                         f"{wb_words.device} is not (OB, {fhb}·{fwb}·"
                         f"{oa // bitpack.PACK}) on {dev}")
    if not 0 < ka <= la * bitpack.PACK or not 0 < kb <= lb * bitpack.PACK:
        raise ValueError(f"ka={ka} outside 1..{la * bitpack.PACK} or kb={kb} "
                         f"outside 1..{lb * bitpack.PACK}")
    pf = 2 if pool else 1
    if h % pf or w % pf or n > 65535 or th < 1 or tw < 1:
        raise ValueError(f"unsupported pair geometry: N={n}, map {h}x{w}, "
                         f"pool={pool}, tile ({th}, {tw})")
    for c, f, o in ((thr_a_c, thr_a_flip, oa), (thr_b_c, thr_b_flip, ob)):
        if c is None:
            raise ValueError("the fused pair needs both layers' thresholds")
        check_thresholds(c, f, o, dev)
    out = torch.empty((n, h // pf, w // pf, ob), dtype=torch.int8,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(name, a_words.data_ptr(), wa_words.data_ptr(),
                      thr_a_c.data_ptr(), thr_a_flip.data_ptr(),
                      wb_words.data_ptr(), thr_b_c.data_ptr(),
                      thr_b_flip.data_ptr(), out.data_ptr(), n, h, w, cwa,
                      oa, ob, fha, fwa, fhb, fwb, pf, th, tw,
                      la * bitpack.PACK - ka, lb * bitpack.PACK - kb, stream)
    return out


def xnor_conv2d_pair_vpu(a_words: torch.Tensor, wa_words: torch.Tensor,
                         wb_words: torch.Tensor, **kw) -> torch.Tensor:
    """K5, XNOR + popcount: the fused pair in one launch. Keywords: ka,
    kb, fha, fwa, fhb, fwb, pool, thr_a_c, thr_a_flip, thr_b_c,
    thr_b_flip, th, tw."""
    out = _launch("xnor_conv2d_pair_vpu", a_words, wa_words, wb_words, **kw)
    launch_count.add(xnor_conv2d_pair_vpu)
    return out


def xnor_conv2d_pair_mxu(a_words: torch.Tensor, wa_words: torch.Tensor,
                         wb_words: torch.Tensor, **kw) -> torch.Tensor:
    """K5 via ±1 int8 unpack + tensor-core dot; same contract and cluster
    as ``xnor_conv2d_pair_vpu``."""
    out = _launch("xnor_conv2d_pair_mxu", a_words, wa_words, wb_words, **kw)
    launch_count.add(xnor_conv2d_pair_mxu)
    return out


xnor_conv2d_pair_vpu.launches = 0
xnor_conv2d_pair_mxu.launches = 0
