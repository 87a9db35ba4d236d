"""Wrappers of the CUDA direct binary conv kernels K3 and K4
(``csrc/xnor_conv.cu``), and the per-position filter packing they read.

* ``xnor_conv2d_vpu`` (K3) replaces ``repro/kernels/xnor_conv.py::
  xnor_conv2d_vpu``: XNOR + ``__popc`` over a halo tile in shared memory.
* ``xnor_conv2d_mxu`` (K4) replaces ``repro/kernels/xnor_conv.py::
  xnor_conv2d_mxu``: gathered patch rows, ±1 int8 unpack, WMMA dot.

Both take the channel-packed NHWC image (N, H, W, Cw) int32 — unpadded:
the kernels read zero words (−1 bits) outside the image — and the
per-position packed filters (O, FH·FW·Cw) int32 of ``pack_conv_weights``.
They return (N, HO, WO, O) int32 agree-counts, or int8 bits when
thresholds are given, launch on the current stream, allocate only their
output and count their launches (``xnor_conv2d_vpu.launches``). The plain
version is ``kernels/ref.py::xnor_conv2d_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build
from repro_torch.kernels.xnor_matmul import check_thresholds, check_words


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
    xnor_conv2d_vpu.launches += 1
    return out


def xnor_conv2d_mxu(a_words: torch.Tensor, w_words: torch.Tensor, *, k: int,
                    fh: int, fw: int, stride: int = 1,
                    pad: tuple[int, int] = (1, 1),
                    thr_c: torch.Tensor | None = None,
                    thr_flip: torch.Tensor | None = None) -> torch.Tensor:
    """K4: K3's contract via ±1 int8 unpack + tensor-core dot."""
    out = _launch("xnor_conv2d_mxu", a_words, w_words, k, fh, fw, stride,
                  pad, thr_c, thr_flip)
    xnor_conv2d_mxu.launches += 1
    return out


xnor_conv2d_vpu.launches = 0
xnor_conv2d_mxu.launches = 0
