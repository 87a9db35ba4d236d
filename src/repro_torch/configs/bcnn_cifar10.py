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

# Fleet serving (serve/router.py, launch/serve_bcnn.py --replicas): the
# request router over N replicated engines. ROUTER_REPLICAS = 1 keeps the
# single-engine path (the router tier is opt-in); ROUTER_MAX_QUEUE bounds
# the admission backlog (past it requests are shed with a typed
# RouterOverload); ONLINE_DEADLINE_S is the latency SLO of the "online"
# traffic class (the "bulk" class is best-effort); PRIORITY_MIX is the
# default offered-traffic composition of the mixed Poisson driver
# ("class=weight,...").
ROUTER_REPLICAS = 1
ROUTER_MAX_QUEUE = 256
ONLINE_DEADLINE_S = 0.5
PRIORITY_MIX = "online=3,bulk=1"

# Elastic fleet and mixed-traffic co-scheduling (serve/autoscale.py,
# serve/router.py, launch/serve_bcnn.py --autoscale): the replica count
# tracks offered load between hysteresis watermarks (pressure =
# outstanding images per fleet slot; the config requires down < up/2,
# the oscillation-free invariant), while bulk batches are co-scheduled as
# BULK_CHUNK-image micro-chunks through the same priority/EDF scheduler
# with ONLINE_RESERVE per-replica dispatch slots bulk may never occupy.
AUTOSCALE_MIN_REPLICAS = 1
AUTOSCALE_MAX_REPLICAS = 4
AUTOSCALE_UP_WATERMARK = 2.0
AUTOSCALE_DOWN_WATERMARK = 0.25
AUTOSCALE_WINDOW_S = 0.1
AUTOSCALE_COOLDOWN_S = 0.5
AUTOSCALE_INTERVAL_S = 0.02
ONLINE_RESERVE = 1
BULK_CHUNK = 2
