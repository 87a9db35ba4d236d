"""Wrappers of the CUDA XNOR matmul kernels K1 and K2 (``csrc/xnor_matmul.cu``).

* ``xnor_matmul_vpu`` (K1) replaces ``repro/kernels/xnor_matmul.py::
  xnor_matmul_vpu``: XNOR + ``__popc`` on the CUDA cores.
* ``xnor_matmul_mxu`` (K2) replaces ``repro/kernels/xnor_matmul.py::
  xnor_matmul_mxu``: ±1 int8 unpack + WMMA tensor-core dot, int32 sums.

Both take (M, Kw) and (N, Kw) int32 CUDA tensors and return (M, N) int32
agree-counts, or int8 {0,1} bits when thresholds are given (fused eq. 8).
They launch on the current stream, allocate only their output, and count
their launches in a plain int attribute (``xnor_matmul_vpu.launches``).
The plain version of both is ``kernels/ref.py::xnor_matmul_ref`` (+
``norm_binarize_ref``); ``kernels/ops.py`` runs it on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build


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
    xnor_matmul_vpu.launches += 1
    return out


def xnor_matmul_mxu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K2: K1's contract via ±1 int8 unpack + tensor-core dot."""
    out = _launch("xnor_matmul_mxu", a_words, w_words, k, thr_c, thr_flip)
    xnor_matmul_mxu.launches += 1
    return out


xnor_matmul_vpu.launches = 0
xnor_matmul_mxu.launches = 0
