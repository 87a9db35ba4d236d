"""Wrappers of the CUDA fused conv-pair kernel K5 (``csrc/xnor_conv_fused.cu``)
and the tile rule it shares with the tuner.

* ``xnor_conv2d_pair_vpu`` replaces ``repro/kernels/xnor_conv_fused.py::
  xnor_conv2d_pair_vpu``: both convs by XNOR + ``__popc``, one block per
  (image, tile).
* ``xnor_conv2d_pair_mxu`` replaces ``repro/kernels/xnor_conv_fused.py::
  xnor_conv2d_pair_mxu``: both convs as ±1 int8 ``mma.sync`` m16n8k32 with
  int32 sums (filter rows on M, positions on N), launched as thread-block
  clusters: ``mxu_split`` gives the cluster size C (the largest divisor
  of OA/32 up to 8) and each rank's channels. Rank r computes conv A for
  its OA/C channels over the whole halo, the ranks share the A bit map
  through distributed shared memory, and rank r computes conv B for its
  ceil-split share of OB. A cluster shape the card cannot schedule makes
  the launch raise; there is no other mxu kernel to fall back to.

One launch computes conv A → eq. 8 → conv B → eq. 8 → optional flip-aware
2×2 pool; the A-output bit map stays in shared memory. Both take the
unpadded channel-packed input (N, H, W, CwA) int32, the per-position
packed filters (OA, FHa·FWa·CwA) and (OB, FHb·FWb·OA/32) int32
(``xnor_conv.pack_conv_weights``), float32/bool thresholds of shape (OA,)
and (OB,), and a (th, tw) output tile; they return (N, H/pf, W/pf, OB)
int8 bits, launch on the current stream, allocate only their output and
count their launches (``xnor_conv2d_pair_vpu.launches``). The plain
version is ``kernels/ref.py::xnor_conv2d_pair_ref``.

Tiles. A block computes one th × tw tile of the pair's output (mxu: its
share of one tile's channels); its shared memory holds the input halo,
the A bit map over the halo and a chunk of filter rows (vpu: 128 rows of
either conv; mxu: up to ``MXU_ROWS`` rows of each conv, conv B's loading
while conv A runs). ``halo_scratch`` returns those bytes exactly as the CUDA
launchers allocate them, and a tile is legal when both variants fit the
per-block limit. ``pick_tiles`` starts from the largest power-of-two tile
up to (TH, TW) and halves it while it is illegal or the tile grid of one
image is smaller than ``MIN_TILES``: with the engine's 4 slots that keeps
at least 128 tiles in flight, about one per SM of the H100 (132). Tiles
never change bits.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build
from repro_torch.kernels.xnor_matmul import check_thresholds, check_words

TH = 8                  # largest tile the rule and the tuner consider
TW = 8
MIN_TILES = 32          # tiles per image the default tile aims for
SMEM_PER_BLOCK = 232448  # H100: opt-in shared memory per block (227 KB)
VARIANTS = ("vpu", "mxu")
# Mirrors of csrc/xnor_conv_fused.cu: the vpu kernel stages CHUNK filter
# rows at an odd word stride; the mxu kernel stages up to MR filter rows of
# each conv per pass, as they lie in device memory, runs in clusters of at
# most MAX_CLUSTER blocks, and its static shared memory (MxuStatic) is one
# int32 m16n8 tile per warp (8 warps) for split-K partial sums and two
# 8-byte mbarriers.
VPU_CHUNK = 128
MXU_ROWS = 64
MXU_MAX_CLUSTER = 8
MXU_STATIC_BYTES = 8 * 16 * 8 * 4 + 2 * 8


def mxu_split(oa: int, ob: int) -> tuple[int, list[tuple[int, int]],
                                        list[tuple[int, int]]]:
    """The mxu launcher's cluster: (C, conv A channel ranges, conv B channel
    ranges) per rank. C is the largest divisor of OA/32 that is at most
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


def halo_scratch(th: int, tw: int, *, pf: int, fha: int, fwa: int,
                 cwa: int, fhb: int, fwb: int, oa: int,
                 variant: str) -> int:
    """Shared-memory bytes one block of ``variant`` allocates for a
    (th, tw) output tile: the input halo (pf·th+FHb+FHa−2) ×
    (pf·tw+FWb+FWa−2) × CwA words and the A bit map (pf·th+FHb−1) ×
    (pf·tw+FWb−1) × OA/32 words, plus the vpu's staged filter chunk, or
    the mxu's min(OA/C, R) conv A rows and R conv B rows (OB does not
    enter: a share beyond R streams in passes; ``mxu_pass_rows`` gives R)
    and its static shared memory (``MXU_STATIC_BYTES``)."""
    ha, wa = pf * th + fhb - 1, pf * tw + fwb - 1
    words = (ha + fha - 1) * (wa + fwa - 1) * cwa + ha * wa * (oa // 32)
    la, lb = fha * fwa * cwa, fhb * fwb * (oa // 32)
    if variant == "vpu":
        return 4 * (words + VPU_CHUNK * (max(la, lb) | 1))
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
    xnor_conv2d_pair_vpu.launches += 1
    return out


def xnor_conv2d_pair_mxu(a_words: torch.Tensor, wa_words: torch.Tensor,
                         wb_words: torch.Tensor, **kw) -> torch.Tensor:
    """K5 via ±1 int8 unpack + tensor-core dot; same contract as
    ``xnor_conv2d_pair_vpu``."""
    out = _launch("xnor_conv2d_pair_mxu", a_words, wa_words, wb_words, **kw)
    xnor_conv2d_pair_mxu.launches += 1
    return out


xnor_conv2d_pair_vpu.launches = 0
xnor_conv2d_pair_mxu.launches = 0
