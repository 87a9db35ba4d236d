"""Fold an LM zoo tree into its packed serving form (counterpart of
``repro/serve/packing.py``): the paper's deployment form, applied to LMs.

Every large projection ``{"w": (…, in, out)}`` becomes ``{"w_packed": (…,
out, in/32) int32, "alpha": (…, out) float32}``: 1 bit a weight and one
scale per output channel (XNOR-Net's α = mean |w| over the input axis).
Leading axes (the layer stacks, MoE expert stacks) are kept: the
reference ``vmap``s its 2-D fold over them, which is the same as folding
the last two axes. By the paper's first / last-layer rule the embedding,
the LM head, the MoE router, the norms and the modality frontends stay
full precision, and MLA's ``wk_b`` / ``wv_b`` too (the absorbed decode
reads them raw).

``models/layers.py::dense`` dispatches on the ``"w_packed"`` key and
unpacks in-graph into a plain product, as the reference's does (no
Pallas kernel there), so the model code is the same for both trees.

α's float32 sum over the input rows runs in windows of 32 rows, then
over the window sums in windows of 32 again, and so on (zero-padded at
the high end): the order of XLA's CPU reduction, so the port's α equals
the reference's bit for bit on the CPU wherever every level's count of
windows is at most 32 or a multiple of 32 (the rows of every packed
weight at the widths of the LM zoo's dense, audio and test configs).
The order is the same on every device.
"""
from __future__ import annotations

import re

import torch

from repro_torch.core import bitpack

# paths that stay full precision (paper §3.1: first layer; §3.3: output
# layer; the router is precision-critical like the first layer). wk_b /
# wv_b: MLA's absorbed decode folds these into q / out in fp layout
_KEEP_FP = re.compile(
    r"embed|head|router|vision_proj|audio_proj|wk_b|wv_b")

_WINDOW = 32        # rows a window of the α sum


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """float32 sum over axis -2 in ``_WINDOW``-row windows, recursively;
    each window (and the last level) summed front to back."""
    while True:
        n = t.shape[-2]
        if n <= _WINDOW:
            acc = t[..., 0, :]
            for i in range(1, n):
                acc = acc + t[..., i, :]
            return acc
        pad = -n % _WINDOW
        if pad:
            t = torch.cat([t, t.new_zeros((*t.shape[:-2], pad, t.shape[-1]))],
                          dim=-2)
        t = t.reshape(*t.shape[:-2], -1, _WINDOW, t.shape[-1])
        acc = t[..., 0, :]
        for i in range(1, _WINDOW):
            acc = acc + t[..., i, :]
        t = acc


def _pack_leaf(w: torch.Tensor) -> dict:
    """(…, in, out) real weights → ``{"w_packed": (…, out, in/32) int32,
    "alpha": (…, out) float32}``; the last input word is padded with −1
    bits."""
    w32 = w.to(torch.float32)
    return {"w_packed": bitpack.pack_pm1(w32.transpose(-1, -2)),
            "alpha": _sum_rows(w32.abs()) / w32.shape[-2]}


def _eligible(w: torch.Tensor, path: str) -> bool:
    return (w.dim() >= 2 and not _KEEP_FP.search(path)
            and w.shape[-2] % bitpack.PACK == 0 and w.shape[-2] >= 256)


def pack_params_for_serving(params: dict) -> dict:
    """A copy of ``params`` with every eligible ``{"w": …}`` projection
    and MoE expert stack (``wi`` / ``wg`` / ``wo`` of 3 or 4 dims) folded
    by ``_pack_leaf``; every other leaf is the caller's tensor."""
    def walk(node, path: str):
        if not isinstance(node, dict):
            return node
        if set(node) == {"w"} and _eligible(node["w"], path):
            return _pack_leaf(node["w"])
        out = {}
        for k, v in node.items():
            sub = f"{path}/{k}"
            if (k in ("wi", "wg", "wo") and isinstance(v, torch.Tensor)
                    and v.dim() in (3, 4) and _eligible(v, sub)):
                out[k] = _pack_leaf(v)          # MoE expert stacks (…, E, ·, ·)
            else:
                out[k] = walk(v, sub)
        return out
    return walk(params, "")


def packed_fraction(params: dict) -> float:
    """The share of the parameters stored at 1 bit (a packed word counts
    32; α is left out)."""
    packed = total = 0

    def walk(node, key: str):
        nonlocal packed, total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif key.endswith("w_packed"):
            packed += node.numel() * bitpack.PACK
            total += node.numel() * bitpack.PACK
        elif not key.endswith("alpha"):
            total += node.numel()
    walk(params, "")
    return packed / max(total, 1)
