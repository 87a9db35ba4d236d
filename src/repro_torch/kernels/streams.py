"""A CUDA stream that no other live captured step holds.

``core/bcnn.py::PackedForward`` captures its step into a CUDA graph on its
stream while other replicas serve on theirs, and a capture takes in
whatever any thread enqueues on the capturing stream, so two live forwards
must never share one. ``torch.cuda.Stream()`` hands out PyTorch's pooled
streams round robin, 32 per device and priority: a process that asks for
a 33rd gets the first again. ``acquire`` draws from the pool until it
finds a stream no holder has and marks it held; ``release`` (the holder's
``close``, or its collection) frees it. The pooled streams themselves live
as long as the process, so nothing that PyTorch's allocators or cuBLAS
keep per stream ever outlives its stream.
"""
from __future__ import annotations

import threading

import torch

POOL = 32       # streams per device and priority in PyTorch's pool

_LOCK = threading.Lock()
_HELD: set[tuple[int, int]] = set()


def _key(stream: torch.cuda.Stream) -> tuple[int, int]:
    return stream.device_index, stream.stream_id


def acquire(device: torch.device) -> torch.cuda.Stream:
    """A pooled stream of CUDA ``device`` that no holder has, now held.
    Raises when all ``POOL`` are held."""
    with _LOCK:
        for _ in range(POOL):
            stream = torch.cuda.Stream(device)
            if _key(stream) not in _HELD:
                _HELD.add(_key(stream))
                return stream
    raise RuntimeError(f"all {POOL} pooled CUDA streams of {device} are held "
                       f"by live captured steps; close one first")


def release(stream: torch.cuda.Stream) -> None:
    """Let ``acquire`` hand ``stream`` out again (idempotent)."""
    with _LOCK:
        _HELD.discard(_key(stream))
