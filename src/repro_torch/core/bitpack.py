"""Bit-packing utilities: the paper's ±1 → {1,0} encoding (§3.1).

Counterpart of ``repro/core/bitpack.py`` with the same conventions:

* ``PACK`` = 32 bits per int32 word, packed along the **last** axis.
* Bit i of word j holds element ``j*32 + i`` (LSB-first).
* ±1 encoding: ``bit = (x >= 0)`` — the paper's eq. (4) sign rule.

PyTorch has no popcount and no unsigned 32-bit shift on the CPU, and its
``int32 >>`` is arithmetic. So words are built in int64 and wrapped back
into the int32 range explicitly, bits are read as ``(x >> s) & 1`` (the
``& 1`` discards the sign fill), and popcounts are a SWAR reduction in
int64.
"""
from __future__ import annotations

import torch

PACK = 32  # bits per packed int32 word

_WRAP = 1 << 32


def packed_len(k: int) -> int:
    """Number of int32 words needed for k bits."""
    return (k + PACK - 1) // PACK


def pad_to_pack(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of PACK bits (zero bits encode −1;
    callers subtract the matching ``n_pad`` agreements)."""
    axis = axis % x.ndim
    rem = (-x.shape[axis]) % PACK
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} values along the last axis into LSB-first int32 words.

    Input (..., K) with K % 32 == 0; output (..., K//32) int32.
    """
    k = bits.shape[-1]
    if k % PACK:
        raise ValueError(f"pack_bits needs K % 32 == 0, got {k}")
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], k // PACK, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(dim=-1)                 # in [0, 2**32)
    words = torch.where(words >= _WRAP // 2, words - _WRAP, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Inverse of pack_bits: (..., n_words*32) {0,1} int8, truncated to k."""
    shifts = torch.arange(PACK, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * PACK)
    if k is not None:
        bits = bits[..., :k]
    return bits.to(torch.int8)


def encode_pm1(x: torch.Tensor) -> torch.Tensor:
    """±1-valued (or real) tensor → {0,1} bits via the sign rule (eq. 4)."""
    return (x >= 0).to(torch.int8)


def decode_pm1(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """{0,1} bits → ±1 values: 1→+1, 0→−1."""
    return bits.to(dtype) * 2 - 1


def pack_pm1(x: torch.Tensor) -> torch.Tensor:
    """Real/±1 tensor → packed int32 words (pads the last axis with −1s)."""
    return pack_bits(pad_to_pack(encode_pm1(x)))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR in int64), as int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def xnor_popcount_words(a_words: torch.Tensor,
                        w_words: torch.Tensor) -> torch.Tensor:
    """Per-word XNOR + popcount: the agreeing bit positions of each word
    of ``~(a ^ w)``, as int32 (..., n_words)."""
    return popcount32(~(a_words ^ w_words)).to(torch.int32)


def xnor_dot(a_words: torch.Tensor, w_words: torch.Tensor,
             k: int) -> torch.Tensor:
    """Paper eq. (5): agree-count among the first k bits (int32).

    Pad bits are 0 in both operands, so each agrees; subtract n_pad.
    """
    n_pad = a_words.shape[-1] * PACK - k
    agree = xnor_popcount_words(a_words, w_words).sum(dim=-1)
    return (agree - n_pad).to(torch.int32)


def pm1_from_xnor(y_l: torch.Tensor, k: int) -> torch.Tensor:
    """Paper eq. (6): y_lo = 2·y_l − k, agree-counts back to ±1 sums."""
    return 2 * y_l - k


def packed_nbytes(shape: tuple[int, ...]) -> int:
    """Device bytes of a packed tensor whose unpacked last axis is
    ``shape[-1]``."""
    n = 1
    for d in shape[:-1]:
        n *= d
    return n * packed_len(shape[-1]) * 4
