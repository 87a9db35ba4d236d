"""Plain PyTorch reference of the paper's Table 2 BCNN (arXiv:1702.06392),
from the latent float weights: no packing, no kernels, nothing of the
program under test.

    Every sum of integer products is rounded to the integer it is, so
    that no convolution algorithm's rounding can move it.

    CONV-1   eq. 7: the input quantized to 6 bits, round(clip(x, 0, 1) * 62
             - 31); the weights to 2 bits, q = round(clip(w / max|w|, -1,
             1)) in {-1, 0, 1} times max|w|; the integer dot sum(a0 * q)
             times max|w|, then batch norm with the stored statistics
             (eps 1e-4) and sign (>= 0 -> +1). float32, each operation
             rounded on its own: the arithmetic the configuration states.
    CONV-2..6 +-1 maps padded with -1 (bit 0 of the {1, 0} encoding, where
             the paper pads with zeros) x sign(w) (eq. 4: >= 0 -> +1), 3x3
             valid; a 2x2 max-pool of the integer sums where Table 2 pools;
             batch norm and sign (eq. 8's comparator), the norm taken in
             float64 so that its sign is the exact one.
    FC-1..2  the (4, 4, 512) map flattened in (h, w, c) order, +-1 products,
             batch norm in float64, sign.
    FC-3     +-1 products, then batch norm alone in float32 (Fig. 3 step 3):
             the logits.

``dtype`` below float32 (the control) runs every tensor and operation in
that type, and the binary layers' norms too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-4
POOL = (False, True, False, True, False, True)      # CONV-1..6


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _exact(y: torch.Tensor) -> torch.Tensor:
    """A sum of integer products, which is an integer: rounded, so that the
    library's choice of algorithm (a transform-based convolution rounds
    along the way) cannot move it. In float32 these sums (at most 27 * 31
    and 9 * 512 in magnitude) are exact once rounded; in the bfloat16
    control the rounding to bfloat16 stays."""
    return torch.round(y) if y.dtype != torch.bfloat16 else y


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _norm(y: torch.Tensor, p: dict, dt: torch.dtype) -> torch.Tensor:
    """Batch norm with the stored statistics, each operation rounded on
    its own in ``dt``."""
    mean, var, gamma, beta = (p[k].to(dt) for k in
                              ("bn_mean", "bn_var", "bn_gamma", "bn_beta"))
    z = (y.to(dt) - mean) / torch.sqrt(var + BN_EPS)
    z = z * gamma
    return z + beta


def conv1_bits(p: dict, x01: torch.Tensor, dt=torch.float32) -> torch.Tensor:
    """CONV-1 (eq. 7) -> (N, 32, 32, 128) +-1 map in ``dt``."""
    a0 = torch.round(torch.clamp(x01.to(dt), 0.0, 1.0) * 62.0 - 31.0)
    w = p["w"].to(dt)                                   # (O, 3, 3, I)
    scale = torch.clamp(w.abs().max(), min=1e-8)
    q = torch.round(torch.clamp(w / scale, -1.0, 1.0))
    y = _exact(F.conv2d(_nchw(a0), q.permute(0, 3, 1, 2), padding=1))
    y = y.permute(0, 2, 3, 1) * scale
    return _sign(_norm(y, p, dt))


def binary_conv_sums(p: dict, a: torch.Tensor, pool: bool) -> torch.Tensor:
    """+-1 NHWC map x sign(w), padded with -1, optionally 2x2 max-pooled:
    the integer pre-activations (N, H', W', O) in a's dtype."""
    ap = F.pad(a, (0, 0, 1, 1, 1, 1), value=-1.0)
    wb = _sign(p["w"].to(a.dtype)).permute(0, 3, 1, 2)
    y = _exact(F.conv2d(_nchw(ap), wb))
    if pool:
        y = F.max_pool2d(y, 2)
    return y.permute(0, 2, 3, 1)


def forward(params: dict, x01: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 32, 32, 3) images in [0, 1] -> (N, 10) float32 logits.
    ``params``: {"conv1": {...}, "convs": [5 x {...}], "fcs": [3 x {...}]},
    each {"w", "bn_mean", "bn_var", "bn_gamma", "bn_beta"}; conv weights
    (O, 3, 3, I), FC weights (O, I)."""
    exact = torch.float64 if dtype == torch.float32 else dtype
    a = conv1_bits(params["conv1"], x01, dtype)
    for p, pool in zip(params["convs"], POOL[1:]):
        a = _sign(_norm(binary_conv_sums(p, a, pool), p, exact)).to(dtype)
    a = a.reshape(a.shape[0], -1)
    fcs = params["fcs"]
    for j, p in enumerate(fcs):
        y = _exact(a @ _sign(p["w"].to(dtype)).T)
        if j < len(fcs) - 1:
            a = _sign(_norm(y, p, exact)).to(dtype)
        else:
            return _norm(y, p, dtype).to(torch.float32)
    raise AssertionError("unreachable")


def logits(params: dict, images: torch.Tensor, *, block: int = 1024,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``forward`` over ``images`` in blocks of rows, TF32 off, no grad."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return torch.cat([forward(params, images[i:i + block], dtype)
                              for i in range(0, len(images), block)])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
