"""Wrapper of the CUDA flash-attention kernel K7
(``csrc/flash_attention.cu``).

``flash_attention`` (K7) replaces ``repro/kernels/flash_attention.py::
flash_attention``: causal or non-causal GQA softmax attention with an
online softmax, over head-major (B, Hq, S, hd) queries and (B, Hkv, S, hd)
keys and values, float32 or bfloat16, hd <= 256. Keys are masked at the
true S, so no input is padded. It launches on the current stream,
allocates only its output, and counts its launches in the plain int
``flash_attention.launches``. Its plain version is
``kernels/ref.py::flash_attention_ref``; ``kernels/ops.py`` runs that on
CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535          # B * Hq blocks on the grid's y axis


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
    """K7: q (B, Hq, S, hd), k/v (B, Hkv, S, hd), all contiguous CUDA
    tensors of one dtype (float32 or bfloat16), Hq % Hkv == 0 → (B, Hq, S,
    hd) in q's dtype."""
    check_inputs(q, k, v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version for CPU tensors is kernels/ref.py)")
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"q, k and v must be contiguous and on one "
                             f"device, got {name} on {t.device}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    if b * hq > MAX_GRID_Y:
        raise ValueError(f"B * Hq = {b * hq} > {MAX_GRID_Y}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, hq, hkv, s, hd,
                      int(causal), int(q.dtype == torch.bfloat16),
                      hd ** -0.5, stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
