"""Array-integrity hash of the on-disk artifact format (a copy of
``repro/core/crc.py``: both readers must hash identically)."""
from __future__ import annotations

import zlib

import numpy as np


def crc32_array(arr: np.ndarray) -> int:
    """CRC32 over the raw contiguous bytes of ``arr``."""
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
