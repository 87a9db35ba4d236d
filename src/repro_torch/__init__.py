"""PyTorch / CUDA port of the packed BCNN deployment path (``src/repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core/``, ``kernels/``, ``serve/``, ``launch/``, ``configs/``,
``data/``) so each piece has an obvious counterpart. It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Public functions keep the reference layouts: NHWC bit maps, ``(O, FH, FW,
I)`` filters and LSB-first int32 words along the last axis. Every kernel
of ``repro/kernels`` that the deployment path reaches is a hand-written
CUDA kernel here (``kernels/csrc``); on a CPU tensor the wrappers run the
plain PyTorch versions in ``kernels/ref.py`` instead.
"""
