"""The paper's own model: the 9-layer CIFAR-10 BCNN of Table 2 — the
constants the port's trainer and serving tier read (counterpart of
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

# Training defaults (train/bcnn_train.py, launch/train_bcnn.py): the
# Courbariaux/Bengio recipe's operating point and the step-atomic
# checkpoint cadence of the restartable loop.
TRAIN_STEPS = 300
TRAIN_BATCH = 64
TRAIN_LR = 2e-3
TRAIN_CKPT_EVERY = 50

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

# Stage-pipelined step (parallel/bcnn_pipeline.py, launch/serve_bcnn.py
# --pipeline-stages): the number of cost-balanced stages the packed
# 9-layer forward is cut into (1 = the single PackedForward, the default)
# and the micro-batch granule streamed through them.
PIPELINE_STAGES = 1
PIPELINE_MICRO_BATCH = 1

# Data-parallel bulk route (parallel/bcnn_data_parallel.py, --data-shards):
# the paper's large-batch Fig. 7 scenario. DATA_SHARDS replicas of the
# packed network split a bulk batch (0 = no bulk route, slots only);
# DATA_MICRO_BATCH is each shard's granule, so DATA_SHARDS ×
# DATA_MICRO_BATCH is the one chunk shape, and the default
# classify_batch routing threshold.
DATA_SHARDS = 0
DATA_MICRO_BATCH = 8
