"""The paper's own model: the 9-layer CIFAR-10 BCNN of Table 2 — the
constants the port's serving slice reads (counterpart of
``repro/configs/bcnn_cifar10.py``)."""
from __future__ import annotations

from repro_torch.core.bcnn import CONV_SPECS, FC_SPECS          # noqa: F401
# Binary-conv dataflow ("auto" = direct when C % 32 == 0) and cross-layer
# fusion of CONV-3/4 and CONV-5/6 into the K5 kernel (opt-in: bit-exact,
# flip with launch/serve_bcnn.py --conv-fusion or a tuned plan).
from repro_torch.core.bconv import (                            # noqa: F401
    DEFAULT_CONV_FUSION as CONV_FUSION,
    DEFAULT_CONV_STRATEGY as CONV_STRATEGY)

NAME = "bcnn-cifar10"
INPUT_SHAPE = (32, 32, 3)          # CIFAR-10 RGB
N_CLASSES = 10

# Streaming-service defaults (serve/bcnn_engine.py, launch/serve_bcnn.py):
# slot count of the continuously stepped engine.
SERVE_N_SLOTS = 4
