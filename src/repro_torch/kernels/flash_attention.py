"""Wrapper of the CUDA flash-attention kernel K7, in two variants.

``flash_attention`` (K7) replaces ``repro/kernels/flash_attention.py::
flash_attention``: causal or non-causal GQA softmax attention with an
online softmax, over head-major (B, Hq, S, hd) queries and (B, Hkv, S, hd)
keys and values, float32 or bfloat16, hd <= 256. Keys are masked at the
true S, so no input is padded. ``pick_variant`` chooses the kernel from
(dtype, hd) alone:

* "tc" (``csrc/flash_attention_tc.cu``): bf16 at hd 64 or 128, on the
  tensor cores (wgmma, TMA loads). It reads strided head-major views in
  place (the last dimension contiguous, the other strides multiples of 8
  elements, 16-byte aligned; ``tma_ready``), copies any other input, and
  returns a (B, Hq, S, hd) view of a
  (B, S, Hq, hd) buffer, the layout the model's output projection reads.
* "simt" (``csrc/flash_attention.cu``): float32 at every hd, and bf16 at
  the other hd, on the CUDA cores (float32 stays off the tensor cores:
  TF32 would break the float32 card-vs-CPU check of the full-width model).
  hd is a template constant per bucket (``SIMT_HEAD_DIMS``; a smaller hd
  runs in the next bucket); each warp owns 16 query rows of a 64-row
  tile, each lane a 4 x TK/8 register tile of scores and 4 rows x hd/8
  columns of the output, the softmax stays in registers, and K/V tiles of
  ``simt_kv_tile`` keys go through a 2-stage cp.async ring
  (``simt_smem_bytes``). It reads rows of whole 16-byte units: the
  wrapper pads hd with zero columns and copies a non-contiguous or
  unaligned input (``simt_operands``), and returns a contiguous output.

Either launches on the current stream, allocates only its output, and
counts its launches in the plain ints ``flash_attention.launches`` (every
K7 launch), ``flash_attention.launches_tc`` and
``flash_attention.launches_simt``. Its plain version is
``kernels/ref.py::flash_attention_ref``; ``kernels/ops.py`` runs that on
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_count
from repro_torch.kernels.xnor_matmul import aligned16

MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535          # query tiles, grid y of both variants
TC_HEAD_DIMS = (64, 128)
SMEM_PER_BLOCK = 232448     # H100: opt-in shared memory per block (227 KB)
SMEM_PER_SM = 233472        # H100: shared memory of an SM (228 KB) ...
SMEM_RESERVED = 1024        # ... of which the runtime keeps 1 KB a block
# Mirrors of csrc/flash_attention_tc.cu: query rows per block, keys per KV
# tile, depth of the K/V ring
TC_BM, TC_BN, TC_STAGES = 128, 128, 3
# Mirrors of csrc/flash_attention.cu: query rows per block, depth of the
# K/V ring, floats of padding per p row, the hd buckets
SIMT_TQ, SIMT_STAGES, SIMT_PPAD = 64, 2, 8
SIMT_HEAD_DIMS = (64, 96, 112, 128, 192, 256)


def pick_variant(dtype: torch.dtype, hd: int) -> str:
    """The K7 variant for (dtype, hd): "tc" for bfloat16 at hd 64 or 128,
    "simt" for float32 at any hd and bfloat16 at any other hd <= 256.
    Raises ValueError outside K7's contract."""
    if dtype not in (torch.float32, torch.bfloat16) or not (
            1 <= hd <= MAX_HEAD_DIM):
        raise ValueError(f"K7 takes float32 or bfloat16 at 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, got {dtype} at hd {hd}")
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "simt"


def tc_smem_bytes(hd: int) -> int:
    """Shared-memory bytes of one "tc" block (``tc_smem_bytes`` in
    csrc/flash_attention_tc.cu): 1 KB of alignment slack, the bf16 Q tile
    (TC_BM x hd), the K/V ring (TC_STAGES x 2 x TC_BN x hd) and
    1 + 2 x TC_STAGES mbarriers of 8 bytes."""
    return (1024 + TC_BM * hd * 2 + TC_STAGES * 2 * TC_BN * hd * 2
            + 8 * (1 + 2 * TC_STAGES))


def simt_bucket(hd: int) -> int:
    """The template hd the "simt" kernel runs ``hd`` at: the least of
    ``SIMT_HEAD_DIMS`` that holds it (columns past hd are zeros)."""
    return next(b for b in SIMT_HEAD_DIMS if hd <= b)


def _simt_bytes(hd: int, tk: int, esize: int) -> int:
    # float32 Q tile (rows padded by 16 bytes), the K/V ring in the input's
    # dtype (K rows padded by 16 bytes), the warps' float32 p slices
    return (4 * SIMT_TQ * (hd + 4) + SIMT_STAGES * tk * (2 * hd * esize + 16)
            + 4 * SIMT_TQ * (tk + SIMT_PPAD))


def simt_kv_tile(hd: int, dtype: torch.dtype) -> int:
    """Keys per KV tile of the "simt" kernel at ``hd`` (``kv_tile`` in
    csrc/flash_attention.cu): 64 where two blocks of 64 keys fit an SM's
    shared memory, else 32."""
    esize, b = (2 if dtype == torch.bfloat16 else 4), simt_bucket(hd)
    return 64 if 2 * (_simt_bytes(b, 64, esize) + SMEM_RESERVED) <= (
        SMEM_PER_SM) else 32


def simt_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared-memory bytes of one "simt" block at ``hd`` in ``dtype``
    (``simt_smem_bytes`` in csrc/flash_attention.cu, at the bucket's hd and
    KV tile): the float32 Q tile, SIMT_STAGES K and V tiles, the p
    slices."""
    return _simt_bytes(simt_bucket(hd), simt_kv_tile(hd, dtype),
                       2 if dtype == torch.bfloat16 else 4)


def simt_plan(hd: int, dtype: torch.dtype) -> dict:
    """The "simt" instantiation that runs ``hd`` in ``dtype`` on the
    current CUDA device: blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes a thread, dynamic shared bytes, keys per KV tile
    and the hd bucket. Needs the card."""
    info = (ctypes.c_int * 6)()
    _build.launch("flash_attention_simt_plan", hd,
                  int(dtype == torch.bfloat16), info)
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "smem",
                     "kv_tile", "bucket"), info))


def simt_operands(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """q, k and v as the "simt" kernel reads them: contiguous, starting
    on 16 bytes, each row padded with zero columns to whole 16-byte units
    (hd a multiple of 4 in float32, of 8 in bf16). A padded column adds 0
    to every score and yields a zero output column."""
    pad = -q.shape[3] % (16 // q.element_size())
    return tuple(aligned16(torch.nn.functional.pad(t, (0, pad)).contiguous()
                           if pad else t.contiguous()) for t in (q, k, v))


def tma_ready(t: torch.Tensor) -> bool:
    """True when the "tc" kernel's tensor maps can read ``t`` in place:
    last dimension contiguous, the other strides (of dimensions longer
    than 1) multiples of 8 elements (16 bytes), the data 16-byte
    aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 and st > 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])
                    if n > 1))


def _map_strides(t: torch.Tensor) -> list[int]:
    # (batch, head, row) element strides; a dimension of length 1 is never
    # stepped, so it gets a stride the tensor map accepts
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:-1], t.stride()[:-1])]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The shapes and dtypes that K7 and its plain version take: 4-D q
    (B, Hq, S, hd) and k, v (B, Hkv, S, hd), Hq % Hkv == 0, one dtype
    (float32 or bfloat16), S >= 1 and hd <= 256. Raises ValueError."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k and v must be 4-D (B, H, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    if (tuple(k.shape) != (b, hkv, s, hd) or tuple(v.shape) != tuple(k.shape)
            or hkv == 0 or hq % hkv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Hkv, S, hd) with Hq % Hkv == 0 for q "
                         f"{tuple(q.shape)}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"q, k and v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.numel() == 0 or hd > MAX_HEAD_DIM:
        raise ValueError(f"q {tuple(q.shape)}: need S >= 1 and 1 <= hd <= "
                         f"{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """K7: q (B, Hq, S, hd), k/v (B, Hkv, S, hd), CUDA tensors of one
    dtype (float32 or bfloat16), Hq % Hkv == 0 → (B, Hq, S, hd) in q's
    dtype, through the variant ``pick_variant`` names. "tc" reads
    ``tma_ready`` views in place and copies any other input; "simt" reads
    ``simt_operands`` (a copy where the input is not contiguous, not
    16-byte aligned, or its rows are not whole 16-byte units). A "tc"
    barrier wait that has not completed after 60 s traps, which leaves
    the CUDA context unusable for the rest of the process."""
    check_inputs(q, k, v)
    variant = pick_variant(q.dtype, q.shape[3])
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version for CPU tensors is kernels/ref.py)")
        if t.device != q.device:
            raise ValueError(f"q, k and v must be on one device, got {name} "
                             f"on {t.device}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    rows = TC_BM if variant == "tc" else SIMT_TQ
    if -(-s // rows) > MAX_GRID_Y:
        raise ValueError(f"S = {s} needs more than {MAX_GRID_Y} query tiles "
                         f"of {rows}")
    if variant == "tc":
        q, k, v = (t if tma_ready(t) else t.contiguous() for t in (q, k, v))
        out = torch.empty((b, s, hq, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        args = ("flash_attention_tc", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hq, hkv, s, hd, int(causal),
                hd ** -0.5, *_map_strides(q), *_map_strides(k),
                *_map_strides(v), *out.stride()[:3])
    else:
        q, k, v = simt_operands(q, k, v)
        out = torch.empty_like(q)
        args = ("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, hq, hkv, s, q.shape[3], int(causal),
                int(q.dtype == torch.bfloat16), hd ** -0.5)
    with torch.cuda.device(q.device):
        _build.launch(*args, torch.cuda.current_stream().cuda_stream)
    launch_count.add(flash_attention)
    if variant == "tc":
        launch_count.add(flash_attention, "launches_tc")
    else:
        launch_count.add(flash_attention, "launches_simt")
        if out.shape[3] != hd:
            out = out[..., :hd].contiguous()
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
