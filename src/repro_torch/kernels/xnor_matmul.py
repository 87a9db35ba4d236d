"""Wrappers of the CUDA binary matmul kernels K1, K2
(``csrc/xnor_matmul.cu``) and K6 (``csrc/binary_weight_matmul.cu``).

* ``xnor_matmul_vpu`` (K1) replaces ``repro/kernels/xnor_matmul.py::
  xnor_matmul_vpu``: XNOR + ``__popc`` on the CUDA cores, a carry-save
  popcount of 16-byte units; a GEMV straight from device memory for
  decode-shaped M (at most ``K1_GEMV_M`` rows), else shared-memory tiles
  with a weight row per lane and 4 activation rows a thread; ``vpu_plan``
  mirrors the launcher's choice.
* ``xnor_matmul_mxu`` (K2) replaces ``repro/kernels/xnor_matmul.py::
  xnor_matmul_mxu``: the 1-bit tensor-core product ``mma.sync m16n8k256
  .b1 .and.popc`` on the packed words (output channels on the MMA's rows,
  activation rows on its columns), K split over warps and a thread-block
  cluster where tiles are too few for a wave; ``mxu_plan`` mirrors the
  launcher's choice.
* ``binary_weight_matmul`` (K6) replaces ``repro/kernels/xnor_matmul.py::
  binary_weight_matmul``: real activations × packed ±1 weights on the
  CUDA cores, float32 sums, as a decode-shaped GEMV (one warp per 4
  output columns and a row tile that holds M, K split over the lanes,
  no shared memory, no block barrier); ``bw_plan`` mirrors its grid.

K1 and K2 take (M, Kw) and (N, Kw) int32 CUDA tensors and return (M, N)
int32 agree-counts, or int8 {0,1} bits when thresholds are given (fused
eq. 8); their plain version is ``kernels/ref.py::xnor_matmul_ref`` (+
``norm_binarize_ref``). K6 takes (M, Kw·32) float32 or bfloat16
activations and (N, Kw) int32 words and returns (M, N) in the
activations' dtype; its plain version is ``kernels/ref.py::
binary_weight_matmul_ref``. Every wrapper launches on the current stream,
allocates only its output, and counts its launches in a plain int
attribute (``xnor_matmul_vpu.launches``, through
``kernels/launch_count.py``, which also counts CUDA-graph replays);
``kernels/ops.py`` runs the plain versions on CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build, launch_count


# Mirrors of csrc/xnor_matmul.cu (K2) and csrc/bits.cuh: 4 warps a block,
# at most K2_PASS words of K staged per pass, a wave of WAVE blocks (the
# H100's SMs), clusters of at most MAX_CLUSTER, the per-block limit.
K2_THREADS = 128
K2_PASS = 256
WAVE = 132
MAX_CLUSTER = 8
SMEM_PER_BLOCK = 232448


# ... and K1 (csrc/xnor_matmul.cu): 4 warps a block in both regimes; the
# GEMV serves M <= K1_GEMV_M; tiles of K1_BN weight rows x at most K1_BM
# activation rows, K1_VP of them a thread, at most K1_PASS words of K a
# pass.
K1_THREADS = 128
K1_GEMV_M = 16
K1_BN = 32
K1_VP = 4
K1_BM = 64
K1_PASS = 256


def pow2_at_least(x: int, lo: int, hi: int) -> int:
    p = lo
    while p < x and p < hi:
        p *= 2
    return p


@dataclass(frozen=True)
class MxuPlan:
    """K2's launch for (M, N, Kw): tiles of ``bn`` output channels x ``bm``
    activation rows, K in 8-word steps split over a cluster of ``cs``
    blocks and, inside a block, over its warps; ``pass_words`` of K staged
    at once; ``smem`` bytes of dynamic shared memory per block."""
    m: int
    n: int
    kw: int
    bn: int
    bm: int
    cs: int
    pass_words: int
    smem: int

    @property
    def steps(self) -> int:
        return -(-self.kw // 8)

    @property
    def blocks(self) -> int:
        return -(-self.n // self.bn) * -(-self.m // self.bm) * self.cs

    def rank_steps(self, rank: int) -> tuple[int, int]:
        return rank * self.steps // self.cs, (rank + 1) * self.steps // self.cs

    def k_slices(self) -> list[tuple[int, int, int]]:
        """(rank, warp k-slice, first word, end word) of every share of K
        one warp computes for one m16 tile: per rank, per pass, the pass's
        steps split over the K2_THREADS / 32 / (bn / 16) warp slices.
        Words past Kw are the zero pad and are cut off here."""
        ksw = K2_THREADS // 32 // (self.bn // 16)
        out = []
        for r in range(self.cs):
            lo, hi = self.rank_steps(r)
            for p0 in range(lo, hi, self.pass_words // 8):
                np_ = min(p0 + self.pass_words // 8, hi) - p0
                for sl in range(ksw):
                    a = p0 + sl * np_ // ksw
                    b = p0 + (sl + 1) * np_ // ksw
                    out.append((r, sl, 8 * a, min(8 * b, self.kw)))
        return out


def mxu_plan(m: int, n: int, kw: int) -> MxuPlan:
    """The launcher's plan (``csrc/xnor_matmul.cu::mm_plan``): the largest
    tiles (64 x 64) shrunk, bn first, until the tiles make a wave; then
    the cluster doubled (at most 8, at least one 8-word step per rank)
    until the blocks do."""
    bm = pow2_at_least(m, 8, 64)
    bn = pow2_at_least(n, 16, 64)

    def tiles():
        return -(-n // bn) * -(-m // bm)

    while tiles() < WAVE and (bn > 16 or bm > 8):
        if bn > 16:
            bn //= 2
        else:
            bm //= 2
    steps = -(-kw // 8)
    cs = 1
    while cs < MAX_CLUSTER and 2 * cs <= steps and tiles() * cs < WAVE:
        cs *= 2
    pass_words = min(-(-steps // cs) * 8, K2_PASS)
    smem = 4 * ((bn + bm) * (pass_words + 4) + bm * (bn + 4))
    return MxuPlan(m, n, kw, bn, bm, cs, pass_words, smem)


@dataclass(frozen=True)
class VpuPlan:
    """K1's launch for (M, N, Kw). ``gemv``: row tile ``mt`` (1, 2 or 4),
    2^``lg`` lanes per weight row, grid (weight-row blocks, row tiles).
    Else tiled: ``bm`` activation rows x K1_BN weight rows a block, ``kc``
    words of K a pass at row stride ``ls``, grid (m tiles, n tiles).
    ``vec``: words per load, 4 where Kw % 4 == 0 (the wrapper copies an
    operand that does not start on 16 bytes)."""
    m: int
    n: int
    kw: int
    gemv: bool
    vec: int
    mt: int = 0
    lg: int = 0
    bm: int = 0
    kc: int = 0
    ls: int = 0
    smem: int = 0

    @property
    def grid(self) -> tuple[int, int]:
        if self.gemv:
            rows = (K1_THREADS // 32) << (5 - self.lg)
            return -(-self.n // rows), -(-self.m // self.mt)
        return -(-self.m // self.bm), -(-self.n // K1_BN)

    @property
    def blocks(self) -> int:
        gx, gy = self.grid
        return gx * gy

    def gemv_lane(self, bx: int, by: int, warp: int, lane: int):
        """(weight row, activation rows, units of K read, rows stored) of
        one GEMV lane: units j0, j0 + 2^lg, ... below Kw / vec; it stores
        the rows r with r mod 2^lg == j0 (of those below M, where its
        weight row is below N)."""
        j0 = lane & ((1 << self.lg) - 1)
        n = ((bx * (K1_THREADS // 32) + warp) << (5 - self.lg)) \
            + (lane >> self.lg)
        rows = [by * self.mt + r for r in range(self.mt)]
        units = list(range(j0, self.kw // self.vec, 1 << self.lg))
        stored = [m for r, m in enumerate(rows)
                  if r % (1 << self.lg) == j0 and m < self.m and n < self.n]
        return n, rows, units, stored

    def passes(self) -> list[tuple[int, int]]:
        """Tiled: (first word, words) of every pass over K."""
        return [(k0, min(self.kc, self.kw - k0))
                for k0 in range(0, self.kw, self.kc)]


def vpu_plan(m: int, n: int, kw: int) -> VpuPlan:
    """The launcher's plan (``csrc/xnor_matmul.cu::k1_plan``): the GEMV
    for M <= K1_GEMV_M (2^lg the least power of two >= the row's units,
    at most 32), else tiles with bm halved from K1_BM (to 16 at least)
    until the blocks make a wave."""
    vec = 4 if kw % 4 == 0 else 1
    if m <= K1_GEMV_M:
        units = kw // vec
        lg = 0
        while (1 << lg) < units and lg < 5:
            lg += 1
        return VpuPlan(m, n, kw, True, vec,
                       mt=1 if m <= 1 else 2 if m == 2 else 4, lg=lg)
    nt = -(-n // K1_BN)
    bm = K1_BM
    while bm > 16 and nt * -(-m // bm) < WAVE:
        bm //= 2
    kc = min(kw, K1_PASS)
    ls = (kc if kc % 8 == 4 else kc + 4) if vec == 4 else kc | 1
    return VpuPlan(m, n, kw, False, vec, bm=bm, kc=kc, ls=ls,
                   smem=4 * (K1_BN + bm) * ls)


# Mirrors of csrc/binary_weight_matmul.cu (K6): a block is one warp of
# BW_NW output columns; a lane takes BW_KV consecutive K elements of each
# 128-element step.
BW_NW = 4
BW_KV = 4


@dataclass(frozen=True)
class BwPlan:
    """K6's launch for (M, N, Kw): blocks of one warp over ``BW_NW``
    output columns and ``mt`` rows (1, 2 or 4: the least that holds M,
    else 4 with ceil(M / 4) row tiles)."""
    m: int
    n: int
    kw: int
    mt: int

    @property
    def grid(self) -> tuple[int, int]:
        return -(-self.n // BW_NW), -(-self.m // self.mt)

    def outputs(self, bx: int, by: int) -> list[tuple[int, int]]:
        """The (m, n) outputs block (bx, by) stores."""
        return [(by * self.mt + r, bx * BW_NW + c) for r in range(self.mt)
                for c in range(BW_NW)
                if by * self.mt + r < self.m and bx * BW_NW + c < self.n]

    def lane_words(self, lane: int) -> list[tuple[int, int]]:
        """(word, first bit) of every BW_KV-element share of K that
        ``lane`` reads, in the order it adds them: word k0 + lane / 8 of
        each 4-word step, bits 4 (lane % 8) onward."""
        return [(k0 + lane // 8, BW_KV * (lane % 8))
                for k0 in range(0, self.kw, 4) if k0 + lane // 8 < self.kw]


def bw_plan(m: int, n: int, kw: int) -> BwPlan:
    """The launcher's plan (``csrc/binary_weight_matmul.cu::launch_bw``)."""
    return BwPlan(m, n, kw, 1 if m <= 1 else 2 if m == 2 else 4)


def check_thresholds(thr_c, thr_flip, n: int, device) -> None:
    """Thresholds for the fused epilogue: float32 c and bool flip, (n,)
    each, contiguous, on ``device`` — or both None."""
    if (thr_c is None) != (thr_flip is None):
        raise ValueError("thr_c and thr_flip go together")
    if thr_c is None:
        return
    for t, dtype, name in ((thr_c, torch.float32, "thr_c"),
                           (thr_flip, torch.bool, "thr_flip")):
        if (t.dtype != dtype or tuple(t.shape) != (n,)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) {dtype} "
                             f"tensor on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def check_words(t: torch.Tensor, ndim: int, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (the plain version "
                         f"for CPU tensors is kernels/ref.py)")
    if t.dtype != torch.int32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D int32 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage does not start on 16
    bytes: K1 and K3 read their operands in 16-byte units."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, a_words, w_words, k, thr_c, thr_flip):
    check_words(a_words, 2, "a_words")
    check_words(w_words, 2, "w_words")
    m, kw = a_words.shape
    n = w_words.shape[0]
    if w_words.shape[1] != kw or w_words.device != a_words.device:
        raise ValueError(f"w_words {tuple(w_words.shape)} on "
                         f"{w_words.device} does not match a_words "
                         f"{tuple(a_words.shape)} on {a_words.device}")
    if bitpack.packed_len(k) != kw:
        raise ValueError(f"k={k} needs {bitpack.packed_len(k)} words, "
                         f"got {kw}")
    check_thresholds(thr_c, thr_flip, n, a_words.device)
    if name == "xnor_matmul_vpu":
        a_words, w_words = aligned16(a_words), aligned16(w_words)
    fused = thr_c is not None
    out = torch.empty((m, n), dtype=torch.int8 if fused else torch.int32,
                      device=a_words.device)
    with torch.cuda.device(a_words.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(name, a_words.data_ptr(), w_words.data_ptr(),
                      thr_c.data_ptr() if fused else None,
                      thr_flip.data_ptr() if fused else None,
                      out.data_ptr(), m, n, kw, kw * bitpack.PACK - k, stream)
    return out


def xnor_matmul_vpu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K1: packed XNOR matmul, XNOR + popcount (paper eq. 5 / eq. 8)."""
    out = _launch("xnor_matmul_vpu", a_words, w_words, k, thr_c, thr_flip)
    launch_count.add(xnor_matmul_vpu)
    return out


def xnor_matmul_mxu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K2: K1's contract on the tensor cores: ``mma.sync m16n8k256 .b1
    .and.popc`` on the packed words as they lie (no unpack), output
    channels on the MMA's rows, activation rows on its columns."""
    out = _launch("xnor_matmul_mxu", a_words, w_words, k, thr_c, thr_flip)
    launch_count.add(xnor_matmul_mxu)
    return out


def binary_weight_matmul(a: torch.Tensor, w_words: torch.Tensor, *,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """K6: real (M, Kw·32) activations × packed (N, Kw) ±1 weights → (M,
    N) in a's dtype. Each activation is rounded to bf16, the ±1 products
    are summed in float32, then multiplied by ``scale`` (N,) float32 when
    given. Activations past the true K must be zero. The kernel reads
    ``a`` in 16-byte (float32) or 8-byte (bf16) units, so an ``a`` whose
    storage does not start on 16 bytes is copied first."""
    if not a.is_cuda:
        raise ValueError("a must be a CUDA tensor (the plain version for "
                         "CPU tensors is kernels/ref.py)")
    if (a.dtype not in (torch.float32, torch.bfloat16) or a.ndim != 2
            or not a.is_contiguous() or a.numel() == 0):
        raise ValueError(f"a must be a non-empty contiguous 2-D float32 or "
                         f"bfloat16 tensor, got {tuple(a.shape)} {a.dtype}")
    check_words(w_words, 2, "w_words")
    m, kp = a.shape
    n, kw = w_words.shape
    if kp != kw * bitpack.PACK or w_words.device != a.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} needs "
                         f"{kw} x 32 columns for w_words {tuple(w_words.shape)}"
                         f" on {w_words.device}")
    if scale is not None and (
            scale.dtype != torch.float32 or tuple(scale.shape) != (n,)
            or scale.device != a.device or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous ({n},) float32 tensor "
                         f"on {a.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")
    if a.data_ptr() % 16:
        a = a.clone()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("binary_weight_matmul", a.data_ptr(),
                      w_words.data_ptr(),
                      scale.data_ptr() if scale is not None else None,
                      out.data_ptr(), m, n, kw,
                      int(a.dtype == torch.bfloat16), stream)
    launch_count.add(binary_weight_matmul)
    return out


xnor_matmul_vpu.launches = 0
xnor_matmul_mxu.launches = 0
binary_weight_matmul.launches = 0
