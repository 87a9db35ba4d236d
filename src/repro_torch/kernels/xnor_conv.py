"""Wrappers of the CUDA direct binary conv kernels K3 and K4
(``csrc/xnor_conv.cu``), and the per-position filter packing they read.

* ``xnor_conv2d_vpu`` (K3) replaces ``repro/kernels/xnor_conv.py::
  xnor_conv2d_vpu``: XNOR + ``__popc`` on the CUDA cores over a halo tile
  in shared memory, lane = output channel, 4 positions a thread, a
  carry-save popcount of 16-byte units; ``vpu_plan`` mirrors the
  launcher's choice of tile.
* ``xnor_conv2d_mxu`` (K4) replaces ``repro/kernels/xnor_conv.py::
  xnor_conv2d_mxu``: the 1-bit tensor-core product ``mma.sync m16n8k256
  .b1 .and.popc`` between filter rows (on the MMA's rows) and the patch
  words of 8 output positions (its columns), read from a halo tile in
  shared memory; ``mxu_plan`` mirrors the launcher's choice of tile.

Both take the channel-packed NHWC image (N, H, W, Cw) int32 — unpadded:
the kernels read zero words (−1 bits) outside the image — and the
per-position packed filters (O, FH·FW·Cw) int32 of ``pack_conv_weights``.
They return (N, HO, WO, O) int32 agree-counts, or int8 bits when
thresholds are given, launch on the current stream, allocate only their
output and count their launches (``xnor_conv2d_vpu.launches``). The plain
version is ``kernels/ref.py::xnor_conv2d_ref``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build, launch_count
from repro_torch.kernels.xnor_matmul import (SMEM_PER_BLOCK, WAVE,
                                             aligned16, check_thresholds,
                                             check_words, pow2_at_least)

# Mirrors of csrc/xnor_conv.cu (K4): 4 warps a block, tiles of up to TH
# output rows of TW columns (an n8 tile is one row), at most K4_NT n8
# tiles per warp unit.
K4_THREADS = 128
K4_NT = 4
TH = 8
TW = 8
# ... and K3: 4 warps a block of K3_BO output channels (lane = channel),
# VP positions a thread, split-L sums and an mbarrier in K3_STATIC bytes
# of static shared memory.
K3_THREADS = 128
K3_BO = 32
VP = 4
K3_STATIC = 4 * (K3_THREADS // 32 // 2) * 32 * VP + 8


def k3_stride(ll: int, vec: int) -> int:
    """Word stride of a staged K3 filter row of ``ll`` words
    (``csrc/xnor_conv.cu::k3_stride``): 16-byte units, ``ll`` where ll = 4
    (mod 8), else ll + 4; 4-byte words, odd."""
    if vec == 4:
        return ll if ll % 8 == 4 else ll + 4
    return ll | 1


@dataclass(frozen=True)
class VpuConvPlan:
    """K3's launch: a block takes ``th`` x TW output positions and K3_BO
    channels of one image, stages its filter rows at ``ls`` words and the
    halo (``sh`` x ``sw`` pixels of Cw words); ``vec`` words per
    shared-memory load; ``smem`` bytes of dynamic shared memory."""
    n: int
    ho: int
    wo: int
    o: int
    ll: int
    vec: int
    th: int
    ls: int
    sh: int
    sw: int
    smem: int

    @property
    def grid(self) -> tuple[int, int, int]:
        """(tiles, channel groups, images)."""
        return (-(-self.ho // self.th) * -(-self.wo // TW),
                -(-self.o // K3_BO), self.n)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def units(self) -> int:
        """Warp units of a block: 32 channels x VP positions."""
        return self.th * TW // VP

    @property
    def ks(self) -> int:
        """Warps that split L for one unit (``run_units``)."""
        nv, ks = self.ll // self.vec, 1
        while 2 * ks * self.units <= K3_THREADS // 32 and 2 * ks <= nv:
            ks *= 2
        return ks


def vpu_plan(n: int, ho: int, wo: int, cw: int, o: int, fh: int, fw: int,
             stride: int) -> VpuConvPlan:
    """The launcher's plan (``csrc/xnor_conv.cu::vpu_plan``): th from
    min(TH, Ho rounded up to a power of two), halved until the blocks make
    a wave, then until the block's shared memory fits. Raises where th = 1
    does not fit, as the launcher refuses the launch."""
    ll, vec = fh * fw * cw, 4 if cw % 4 == 0 else 1
    ls = k3_stride(ll, vec)
    per_tile_row = n * -(-wo // TW) * -(-o // K3_BO)
    th = pow2_at_least(ho, 1, TH)
    while th > 1 and per_tile_row * -(-ho // th) < WAVE:
        th //= 2
    while True:
        sh, sw = (th - 1) * stride + fh, (TW - 1) * stride + fw
        smem = 4 * (K3_BO * ls + sh * sw * cw)
        if smem + K3_STATIC <= SMEM_PER_BLOCK:
            break
        if th == 1:
            raise ValueError(f"K3 cannot fit a block for Cw={cw}, "
                             f"{fh}x{fw}/s{stride}")
        th //= 2
    return VpuConvPlan(n, ho, wo, o, ll, vec, th, ls, sh, sw, smem)


@dataclass(frozen=True)
class MxuConvPlan:
    """K4's launch: a block takes ``th`` x TW output positions and ``bo``
    channels of one image, stages the halo (``sh`` x ``sw`` pixels at
    ``pix`` words each) and streams the filter words ``lc`` at a time;
    ``smem`` bytes of dynamic shared memory."""
    n: int
    ho: int
    wo: int
    o: int
    ll: int
    th: int
    bo: int
    lc: int
    sh: int
    sw: int
    pix: int
    smem: int

    @property
    def steps(self) -> int:
        return -(-self.ll // 8)

    @property
    def blocks(self) -> int:
        return (self.n * -(-self.ho // self.th) * -(-self.wo // TW)
                * -(-self.o // self.bo))

    @property
    def units(self) -> int:
        """(m16 tile, up to K4_NT n8 tiles) units of a block."""
        return self.bo // 16 * -(-self.th // K4_NT)

    @property
    def ks(self) -> int:
        """Warps that split L for one unit: the largest power of two with
        ks·units <= warps and ks <= steps."""
        ks = 1
        while 2 * ks * self.units <= K4_THREADS // 32 and 2 * ks <= self.steps:
            ks *= 2
        return ks

    def l_slices(self) -> list[tuple[int, int, int]]:
        """(warp slice, first word, end word) of every share of L one warp
        computes for one unit: per pass of lc words, the pass's steps split
        over ks slices. Words past L are the zero pad, cut off here."""
        out = []
        for l0 in range(0, self.ll, self.lc):
            q_lo = l0 // 8
            np_ = min(self.lc // 8, self.steps - q_lo)
            for sl in range(self.ks):
                a = q_lo + sl * np_ // self.ks
                b = q_lo + (sl + 1) * np_ // self.ks
                out.append((sl, 8 * a, min(8 * b, self.ll)))
        return out


def _conv_smem(th, bo, lc, sh, sw, pix, ll) -> int:
    tp, l8 = th * TW, -(-ll // 8) * 8
    return 4 * (bo * (lc + 4) + sh * sw * pix + l8 + tp * (bo + 4))


def mxu_plan(n: int, ho: int, wo: int, cw: int, o: int, fh: int, fw: int,
             stride: int) -> MxuConvPlan:
    """The launcher's plan (``csrc/xnor_conv.cu::conv_plan``): bo and th
    from the largest (64, TH), bo halved to 32, then th, then bo to 16
    until the blocks make a wave; then lc (L rounded up to 8), th and bo
    halved until the block's shared memory fits. The pixel stride is the
    least P >= Cw with stride·P = 4 (mod 8), or Cw. Raises where nothing
    fits, as the launcher refuses the launch."""
    ll = fh * fw * cw
    bo = pow2_at_least(o, 16, 64)
    th = pow2_at_least(ho, 1, TH)

    def blocks():
        return n * -(-ho // th) * -(-wo // TW) * -(-o // bo)

    while blocks() < WAVE:
        if bo > 32:
            bo //= 2
        elif th > 1:
            th //= 2
        elif bo > 16:
            bo //= 2
        else:
            break
    pix = next((q for q in range(cw, cw + 8) if stride * q % 8 == 4), cw)
    lc = -(-ll // 8) * 8
    while True:
        sh, sw = (th - 1) * stride + fh, (TW - 1) * stride + fw
        smem = _conv_smem(th, bo, lc, sh, sw, pix, ll)
        if smem <= SMEM_PER_BLOCK:
            break
        if lc > 8:
            lc = (lc // 2 + 7) // 8 * 8
        elif th > 1:
            th //= 2
        elif bo > 16:
            bo //= 2
        else:
            raise ValueError(f"K4 cannot fit a block for Cw={cw}, "
                             f"{fh}x{fw}/s{stride}")
    return MxuConvPlan(n, ho, wo, o, ll, th, bo, lc, sh, sw, pix, smem)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """(O, FH, FW, C) real/±1 filters → (O, FH·FW·Cw) per-position words.

    Each (fh, fw) position's C channels are padded to a 32-bit boundary and
    packed on their own, matching ``pack_bits(pad_to_pack(a_bits))``.
    """
    return bitpack.pack_pm1(w).reshape(w.shape[0], -1)


def _launch(name: str, a_words, w_words, k, fh, fw, stride, pad, thr_c,
            thr_flip):
    check_words(a_words, 4, "a_words")
    check_words(w_words, 2, "w_words")
    n, h, w, cw = a_words.shape
    o, ll = w_words.shape
    if ll != fh * fw * cw or w_words.device != a_words.device:
        raise ValueError(f"w_words {tuple(w_words.shape)} on "
                         f"{w_words.device} is not (O, {fh}·{fw}·{cw}) "
                         f"on {a_words.device}")
    if not 0 < k <= ll * bitpack.PACK:
        raise ValueError(f"k={k} outside 1..{ll * bitpack.PACK}")
    ph, pw = pad
    ho = (h + 2 * ph - fh) // stride + 1
    wo = (w + 2 * pw - fw) // stride + 1
    if ho < 1 or wo < 1 or n > 65535:
        raise ValueError(f"unsupported conv geometry: N={n}, output "
                         f"{ho}x{wo}")
    check_thresholds(thr_c, thr_flip, o, a_words.device)
    if name == "xnor_conv2d_vpu":
        a_words, w_words = aligned16(a_words), aligned16(w_words)
    fused = thr_c is not None
    out = torch.empty((n, ho, wo, o),
                      dtype=torch.int8 if fused else torch.int32,
                      device=a_words.device)
    with torch.cuda.device(a_words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(name, a_words.data_ptr(), w_words.data_ptr(),
                      thr_c.data_ptr() if fused else None,
                      thr_flip.data_ptr() if fused else None,
                      out.data_ptr(), n, h, w, cw, o, fh, fw, stride, ph, pw,
                      ho, wo, ll * bitpack.PACK - k, stream)
    return out


def xnor_conv2d_vpu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    fh: int, fw: int, stride: int = 1,
                    pad: tuple[int, int] = (1, 1),
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K3: direct packed conv, XNOR + popcount, fused eq. 8 optional."""
    out = _launch("xnor_conv2d_vpu", a_words, w_words, k, fh, fw, stride,
                  pad, thr_c, thr_flip)
    launch_count.add(xnor_conv2d_vpu)
    return out


def xnor_conv2d_mxu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    fh: int, fw: int, stride: int = 1,
                    pad: tuple[int, int] = (1, 1),
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K4: K3's contract on the tensor cores: ``mma.sync m16n8k256 .b1
    .and.popc`` on the packed words as they lie (no unpack), output
    channels on the MMA's rows, 8 positions of a tile row on its
    columns."""
    out = _launch("xnor_conv2d_mxu", a_words, w_words, k, fh, fw, stride,
                  pad, thr_c, thr_flip)
    launch_count.add(xnor_conv2d_mxu)
    return out


xnor_conv2d_vpu.launches = 0
xnor_conv2d_mxu.launches = 0
