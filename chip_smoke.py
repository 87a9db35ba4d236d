#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. Print the card's name and power limit, build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time and nvcc's
   register / shared-memory report (spelt out per kernel for K2, K4, K5
   vpu and K6, and per hd bucket and dtype for K7 simt),
   then run the tensor-core rate probe (``kernels/mma_probe.py``: 1-bit
   ``.xor.popc`` and ``.and.popc``, int8, and int8 with a register
   unpack) and print its bit-MAC rates beside the SM clock and power
   limit.
2. Hold each kernel (K1 ``xnor_matmul_vpu``, K2 ``xnor_matmul_mxu``, K3
   ``xnor_conv2d_vpu``, K4 ``xnor_conv2d_mxu``, K5
   ``xnor_conv2d_pair_vpu`` / ``_mxu``) against its plain PyTorch version
   (``kernels/ref.py``) on the card at the Table 2 path's shapes (K5 at
   every legal tile), with and without thresholds, plus ragged, strided,
   unpooled and 5×5 extras (K5: also clusters of fewer than 8 blocks
   and uneven OB shares, ``PAIR_EXTRAS``; each case prints its cluster
   size; K2 and K4: ``MM_EXTRAS`` and ``CONV_EXTRAS``, each printing the
   launcher's plan from its Python mirror); require bit-exact results.
   Both K5 variants are also timed at every legal tile of the path pairs
   (with the sum of each pair's fastest tile beside the default tiles'),
   and K6 beside ``torch.mm`` at M = 4, 16 and 128; K5 vpu and K6 also
   print the profiler's kernel-only µs per call. Time the kernel,
   the plain version and one PyTorch library call on the unpacked ±1
   operands (a yardstick only; the port never calls it; for K5 two cuDNN
   convs and a max-pool) by their device time per call (``device_ms``:
   CUDA events, the calls queued behind a sleep kernel so no host launch
   cost is counted), the kernel also per call as the host sees it, and
   compute each kernel's bound from its bytes and bit-operations.
3. Serve 16 requests through a 4-slot ``BCNNEngine`` on the card, on path
   "mxu" and again on "vpu", unfused and then with the conv pairs fused
   (K5), with launch counters zeroed just before and read just after each
   run; every step is one CUDA-graph replay, and each replay counts its
   launches. Hold the served logits, every layer's and fused pair's
   output (each fed the same input) and CONV-1's bits against the same
   port on the CPU. Hold the replayed logits bitwise equal to the eager
   card forward, over an occupancy sweep 1..4 on one graph
   (``step_cache_size`` 1), and across ``swap_packed`` to a second seed's
   net mid-run (queued requests get the new weights: bitwise equal to its
   eager card forward, allclose to its CPU port; no new capture; every
   weight keeps its storage) and back. Profile each forward eager and
   replayed: wall, device time, idle share, launches.
4. Tune the plan on the card twice (``kernels/autotune.py``, device
   time at batch 4), require the two plans to agree and every candidate
   to be bit-exact, export the plan in an artifact, reload it as the
   cached plan and serve with it against the CPU port.
5. The replica fleet (``serve/router.py``, threaded, the tuned plan shared
   by every replica): 512 requests of mixed online + bulk Poisson traffic
   (``PRIORITY_MIX``) through 2 replicas with a rolling swap mid-drive,
   then through 1 and 2 replicas at the same rate and saturated, each
   with zero drops, a closed ledger per class, one capture a replica, the
   path's launches on every step, every result bitwise equal to its
   stamped epoch's eager card forward and allclose to its CPU port,
   p50/p99 per class and img/s printed; then an autoscaled fleet through
   1 -> 2 -> 1 replicas under a bulk burst, replica 1 captured while
   replica 0 serves. Every wait is bounded.
5b. The multi-device forwards (``parallel/bcnn_pipeline.py``,
   ``parallel/bcnn_data_parallel.py``), every stage and shard side by
   side on the one card, each on its own stream: in all four routes the
   stage pipeline at 1, 2 and 3 stages (micro-batches 1 and 8) and the
   data-parallel forward at 1 and 2 shards and 2 x 2 (micro-batches 8
   and 256) bitwise equal to the route's ``PackedForward`` at N = 1, 7,
   64 and 257, each case 20 times queued back to back, then swapped to a
   second net and equal to its ``PackedForward``; one graph a stage or
   shard; the launches of one call, counters zeroed just before and read
   just after, equal to the plan's (a stage cut through a fused pair
   launches K3/K4 instead of K5); each pipeline's ``stage_times``. The
   engine's ``classify_batch`` through the bulk route (launches counted)
   and the slot route, bitwise equal to ``PackedForward``. On the tuned
   plan, the slot route and the bulk route (1 shard x 8 and x 256) timed
   at N = 16, 256 and 4096 (img/s, host wall, the profiler's device busy
   time and idle share), beside one graph at 4096 images in every route
   and the side-by-side forms at 4096.
6. The XNOR LM at the full ``configs/xnor_lm_tiny.py::CONFIG``: hold the
   probe ``forward_packed`` logits of modes "bw" and "xnor" bitwise equal
   on the card; serve 16 requests through 4 slots in mode "bw" (K6) and in
   mode "xnor" on "vpu" (K1) and "mxu" (K2), each with launch counters
   zeroed just before and read just after, and require the tokens of the
   same port on the CPU; hot-swap a second net mid-run (every weight keeps
   its storage; tokens equal the CPU port's under the same swap); race
   the decode GEMM modes twice on one decode step at 4 slots
   (``autotune_lm_mode``) and require the two to agree; profile one
   decode step.
7. The dense LM zoo at Qwen3-8B's full width (``configs/qwen3_8b.py``):
   a two-layer float32 cut on the card against the same port on the CPU
   (``prefill`` and ``forward_train`` logits, 2 K7 launches per forward,
   all of them the CUDA-core variant "simt"), and against its own
   token-by-token ``decode_step`` on the card; a two-layer bf16 cut's
   ``prefill`` at (1, 4096), every K7 call ("tc", on the views
   ``gqa_forward`` hands over) held against the plain version on the same
   views, and its logits against the same cut with plain attention, and
   with a plain attention that rounds in K7 tc's order (both relative L2
   gaps printed); the
   full 36-layer bf16
   model's ``prefill`` at (1, 4096) (36 K7 launches, all of them the
   tensor-core variant "tc"), profiled; the same model served through ``ServingEngine``'s default
   ``TransformerServeModel`` (16 requests through 4 slots, one request's
   tokens equal to a hand-rolled decode loop, a mid-run hot-swap of a
   second seed's weights in place), and one decode step profiled.
7b. The moe family at DeepSeek-V2-Lite's full width
   (``configs/deepseek_v2_lite_16b.py``): (a) a two-layer float32 cut
   (layer 0 MLA with the dense FFN, layer 1 MLA with the MoE) on the card
   against the same port on the CPU, ``prefill`` and ``forward_train``
   (logits and aux loss; 2 K7 simt launches a forward), under the routing
   rule of ``MOE_ROUTE_MARGIN``; (b) the same at quant "binary_weights";
   (c) ``prefill`` against an 8-token prompt fed through the absorbed
   ``decode_step`` on the card; (d) the full 27-layer bf16 model's
   ``prefill`` at (1, 4096) (27 K7 tc launches at q/k 192, v 128, and
   none simt), profiled,
   with K7's share of the kernel time; (e) the same model served through
   ``ServingEngine`` at 4 slots (no K7 launch in decode; request 0 equal
   to a hand-rolled decode loop; a decode step profiled; a mid-run
   hot-swap keeping every weight's storage); (f) DeepSeek-V2's 236B
   config cut to 2 layers at full width, bf16, ``prefill`` at (1, 1024)
   through K7 tc against the same cut with plain attention on the
   card.
7c. The vlm, ssm and hybrid families at full width
   (``configs/phi3_vision_4_2b.py``, ``rwkv6_3b.py``, ``zamba2_7b.py``):
   (a) each cut in depth (phi-3-vision and rwkv6 to 2 layers, zamba2 to 12
   at ``attn_every`` 6: two shared-block applications) in float32 on the
   card against the same port on the CPU at ``DENSE_TOL``:
   phi-3-vision's ``prefill`` and ``forward_train`` with a (1, 576, 3072)
   frontend and 64 text tokens, the recurrent ones' ``prefill`` at S = 128
   (chunked forms) and 100 (token scans); 2, 2 and 0 K7 simt launches a
   forward; (b) the rwkv6 and zamba2 cuts' ``prefill`` against a 64-token
   prompt fed through ``decode_step``; (c) each whole model in bf16
   prefilled at S = 4096 (phi-3-vision: 576 patches + 3520 tokens) with
   32, 13 and 0 K7 simt launches, timed, its peak memory read and
   profiled with K7's share of the kernel time; (d) each served through
   ``ServingEngine`` at 4 slots (8 requests, prompt 16, 16 new tokens; no
   K7 launch in decode; request 0 equal to a hand-rolled decode loop;
   every reset slot read back zero in every state tensor at admission; a
   decode step profiled; a mid-run hot-swap keeping every weight's
   storage); then a table of the prefill and decode-step rows and the
   phase's wall time.
7d. The audio family at whisper-medium's full width
   (``configs/whisper_medium.py``): (a) a cut to 2 encoder and 2 decoder
   layers in float32, ``_encode``, ``prefill`` and ``forward_train`` at
   (2, 128) on (2, 1500, 1024) float32 frames, card against the CPU port
   at ``DENSE_TOL``, 2 non-causal and 2 causal K7 simt launches a
   forward (``K7Log`` reads each call's ``causal`` and variant); (b) its
   ``prefill`` against a 64-token prompt fed through ``decode_step`` on
   the card given the encoder K/V; (c) the whole bf16 model prefilled at
   (1, 4096) on bf16 frames, 24 non-causal and 24 causal K7 tc launches,
   timed, its peak memory read, profiled with K7's share and the
   encoder's and the cross-attentions' kernel ms apart; (d) served
   through ``ServingEngine`` at 4 slots on float32 frames (8 requests; 24
   K7 simt launches in each admission's encode, none in decode; request
   0 equal to a hand-rolled decode loop; every reset slot's caches read
   back zero while the per-slot encoder K/V keeps its storage and
   contents; an admission's encode and a decode step profiled; a mid-run
   hot-swap keeping every weight's storage); (e) the served weights
   packed on the card (``serve/packing.py``: packed fraction, bytes
   against bf16) and served at quant binary_weights, and the cut's
   packed tree built on the card and on the CPU, equal bit for bit, its
   ``prefill`` card vs CPU at ``DENSE_TOL``; then a summary table and
   the phase's wall time.
8. Training (``train/bcnn_train.py``) at full Table 2 width: one train
   step at batch 64 from ``numpy_params`` latents on the card and on the
   CPU (loss, every gradient, Adam moments, running statistics and the
   updated weights at ``TRAIN_STEP_TOL``; a weight may differ only where
   the two gradients' signs differ or |g| < ``TRAIN_ADAM_FLAT``); the
   default recipe (300 steps, batch 64, checkpoints every 50) straight,
   and again crashed after step 120 and resumed from its checkpoint (all
   136 leaves and the overlapping losses bitwise equal; the loss falls);
   the step timed (CUDA events, images/s) and profiled; a checkpoint's
   bytes and save / restore time; ``evaluate`` through every route (mxu /
   vpu, unfused / fused) with K1–K5's launch counters zeroed just before
   and read just after each, and the 0.97 fold-agreement gate; the
   trained net exported as an artifact, reloaded and served through a
   4-slot ``BCNNEngine`` (logits bitwise equal to ``forward_packed``);
   and the XNOR LM's ``forward_train`` at the full
   ``configs/xnor_lm_tiny.py::CONFIG`` bitwise equal to ``forward_packed``
   in modes "bw" (K6), "xnor" on "vpu" (K1) and "mxu" (K2). The trainer
   runs under ``exact_numerics`` (TF32 off, deterministic algorithms;
   ``CUBLAS_WORKSPACE_CONFIG`` is set before the first cuBLAS call).
8b. LM training of the zoo (``train/train_loop.py``, ``launch/train.py``):
   (a) one ``make_train_step`` step on the card and on the CPU from the
   same weights (TF32 off) for Qwen3-8B cut to 2 layers at full width
   in float32 at ``LM_STEP_TOKENS`` and for the float32 cuts of phases
   7b-7d (``LM_STEP_CUTS``; the moe cut with both routers recorded and
   every token routed alike): loss at rtol 1e-5, every gradient leaf,
   both Adam moments and every updated weight within relative L2 1e-4
   (a weight whose two gradients both lie below ``TRAIN_ADAM_FLAT`` held
   to 2·lr), 0 K7 launches inside each step; (b) Qwen3-8B at full width
   cut to ``LM_TRAIN_LAYERS`` layers, bf16, remat, trained
   ``LM_TRAIN_STEPS`` steps at ``LM_TRAIN_TOKENS`` under
   ``exact_numerics`` with the loss falling, and again crashed after
   step ``LM_TRAIN_CRASH_AT`` and resumed from its checkpoint (every
   leaf of the ``TrainState`` and every overlapping loss bitwise equal),
   the step timed between CUDA events (tokens/s, peak memory) and
   profiled, the checkpoint's bytes and save / restore times; (c) its
   trained weights' ``forward_train`` under ``torch.no_grad()`` through
   K7 tc (one launch a layer) against the blockwise path under autograd
   (no launch), relative L2 at most ``LM_TRAIN_K7_GAP``; (d) the cut at
   quant binary_weights trained ``LM_TRAIN_BW_STEPS`` steps with the
   loss falling, packed (``serve/packing.py``), its packed ``prefill``
   against the latent tree's STE ``prefill`` (K7 tc in both) and served
   at 4 slots, request 0 equal to a hand-rolled decode loop on the packed
   tree; (e) ``python -m repro_torch.launch.train --smoke`` on the card
   crashed after step 2 and ``--resume``d to step 4.
9. The LM zoo's multi-device forms (``parallel/pipeline.py``,
   ``launch/mesh.py``, ``launch/dryrun_lib.py``): (a) Qwen3-8B at full
   width and depth, bf16, ``MULTI_LM_MICRO`` microbatches of
   ``MULTI_LM_TOKENS`` embedded tokens pipelined through
   ``MULTI_LM_STAGES`` stages (``plan_stages``) side by side on the card
   (a mesh of the one device repeated), each layer
   ``transformer._apply_dense_attn`` under ``torch.no_grad()``: the
   pipeline bitwise equal to ``sequential_forward`` and that to
   ``_decoder_stack`` per microbatch, exactly one K7 tc launch a layer
   and microbatch, both forms timed (host wall and CUDA events) and
   profiled, each stage's device ms for one microbatch, K7 tc alone at
   the path's (1, 32, 8, 128), S = 1024; (b) the same model cut to 2
   layers, float32, pipelined over 2 stages on the card against the
   port's ``sequential_forward`` on the CPU at ``DENSE_TOL`` (K7 simt at
   hd 128); (c) the dry run's one-device report
   (``make_local_mesh``) of a prefill (1, 4096): its param bytes equal
   to the card's tree, its FLOPs beside phase 7's measured kernel ms, its
   resident + temp bytes beside a measured ``max_memory_allocated``.

Phase 2 also holds K7 against its plain version at the dense LM's attention
shape (B, Hq, Hkv, hd) = (1, 32, 8, 128), causal, S in {128, 1000, 4096}, at
the same heads with hd 32, 96, 112 and 192 at S = 4096, and at the ragged
extras (2, 4, 2, 64) at S = 256, (1, 2, 1, 64) at S = 200, both causal
settings, (1, 4, 2, hd) at S = 300 for hd 32, 96, 112 and 192, (1, 2, 1,
256) at S = 200 non-causal and (1, 2, 2, 33) at S = 65 (rows the wrapper
pads to 16 bytes), in float32 and bfloat16, and at DeepSeek-V2-Lite's MLA
shape (1, 16, 16, 192) with v at 128 at S = 4096, causal, at (8, 16, 16,
192) / 128 at S = 1024 and at (1, 4, 2, 192) / 128 at S = 300, both causal
settings (``FLASH_MLA_CASES``), phi-3-vision's (1, 32, 32, 96) at S = 4096
and 4672 (576 patches + 4096 tokens) and zamba2's (1, 32, 32, 112) at S =
4096 (``FLASH_VLM``, ``FLASH_VLM_RAGGED``, ``FLASH_HYBRID``), in bfloat16
only, and whisper-medium's encoder shape (1, 16, 16, 64) at S = 1500,
non-causal (``FLASH_AUDIO``, both dtypes; in bf16 the last of the 128-row
tiles is ragged) (tolerances ``FLASH_TOL``), each in the variant
``pick_variant`` chooses (printed from the launch counters): "tc"
(``flash_attention_tc``, bf16 at hd 64 / 128 and at MLA's 192 / 128) on
contiguous tensors and on the strided head-major views the model hands over,
"simt" (``flash_attention``) on everything else. Before them it prints the
"simt" plan of every hd bucket from the card (``kfa.simt_plan``: blocks an
SM by the occupancy API, registers and local bytes a thread, shared bytes,
KV tile) and requires 2 blocks an SM at hd <= 128 in float32; the build
phase prints ptxas's line of every ``flash_simt_kernel`` instantiation. It
times every row against one ``scaled_dot_product_attention`` call on the
same inputs (a yardstick the port never calls); the kernels line takes each
variant at S = 4096 in the dtype it serves there (tc bf16) and simt at
``FLASH_SIMT_PATH``. Then it runs "tc" at the reference's ``prefill_32k``
length (S = 32768, causal, bf16), which the plain version cannot hold (137
GB of scores), against SDPA's output at the bf16 tolerances.

Phase 2 also holds K1/K2 bit-exact against their plain version at the
LM's mode-"xnor" shapes (M = 4 per decode step and 16 for the probe,
every projection's (K, N), no thresholds) and at the im2col shapes of
CONV-2..6 (timed and summed apart from the kernels line), and K6
(``binary_weight_matmul``) at the LM's shapes: bit-exact on ±1
activations, allclose on real float32 / bfloat16 activations with a
scale, at the tolerances of tests/test_torch_bw_matmul.py.

Prints one JSON line of per-kernel numbers, then, last, the result line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SLOTS = 4
N_REQUESTS = 16
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the HBM3
# rate and the bf16 tensor-core rate live in the package, beside the dry
# run that prices cells with them (``hw()``); the dense int8 tensor-core
# rate and the float32 CUDA-core rate here. Integer issue rates per SM
# per clock for compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput): population count 16, 32-bit
# bitwise operations and adds 64.
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12          # CUDA cores, no tensor cores
POPC_PER_CLK_PER_SM = 16
ALU_PER_CLK_PER_SM = 64
# What the carry-save core of K1, K3 and K5 vpu (csrc/bits.cuh::csa_unit)
# issues per 16-byte unit, 4 words = 128 bit-MACs of one filter row
# against one position: 4 XORs and two full adders of 2 LOP3s each, 2
# popcounts, 1 IADD3 adding both to the running sum.
CSA_UNIT = {"bits": 128, "lop3": 8, "popc": 2, "iadd3": 1}

SOURCES = {
    "xnor_matmul_vpu": ("src/repro_torch/kernels/csrc/xnor_matmul.cu",
                        "src/repro/kernels/xnor_matmul.py:83"),
    "xnor_matmul_mxu": ("src/repro_torch/kernels/csrc/xnor_matmul.cu",
                        "src/repro/kernels/xnor_matmul.py:139"),
    "xnor_conv2d_vpu": ("src/repro_torch/kernels/csrc/xnor_conv.cu",
                        "src/repro/kernels/xnor_conv.py:170"),
    "xnor_conv2d_mxu": ("src/repro_torch/kernels/csrc/xnor_conv.cu",
                        "src/repro/kernels/xnor_conv.py:189"),
    "xnor_conv2d_pair_vpu": (
        "src/repro_torch/kernels/csrc/xnor_conv_fused.cu",
        "src/repro/kernels/xnor_conv_fused.py:226"),
    "xnor_conv2d_pair_mxu": (
        "src/repro_torch/kernels/csrc/xnor_conv_fused.cu",
        "src/repro/kernels/xnor_conv_fused.py:237"),
    "binary_weight_matmul": (
        "src/repro_torch/kernels/csrc/binary_weight_matmul.cu",
        "src/repro/kernels/xnor_matmul.py:196"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87"),
    "flash_attention_tc": (
        "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "src/repro/kernels/flash_attention.py:87"),
}
# Table 2 binary convs: (H=W, C, O); FCs: (N, k, thresholds)
CONV_SHAPES = [(32, 128, 128), (16, 128, 256), (16, 256, 256),
               (8, 256, 512), (8, 512, 512)]
FC_SHAPES = [(1024, 8192, True), (1024, 1024, True), (10, 1024, False)]
# Table 2 fused pairs CONV-3/4 and CONV-5/6: (H=W, C, OA, OB), 3x3, pooled
PAIR_SHAPES = [(16, 128, 256, 256), (8, 256, 512, 512)]
# K1/K2 extras (M, N, k, thresholds): ragged rows and K, one bit, a K
# split over a cluster that does not divide Kw = 259 words
MM_EXTRAS = [(5, 1000, 1170, True), (37, 77, 33, False), (1, 1, 1, False),
             (9, 17, 257, True), (N_SLOTS, 64, 259 * 32 - 5, True)]
# ... and K1's regimes (kernels/xnor_matmul.py::vpu_plan): M = 16, the
# largest the GEMV takes (4 row tiles), and M = 17 and 64, tiled: 16-byte
# units, ragged N, K in 3 passes of at most 256 words; 4-byte units
# (Kw = 259) in 2
MM_EXTRAS += [(16, 1024, 8192, True), (17, 1024, 1024, True),
              (64, 300, 600 * 32, False), (17, 65, 259 * 32 - 5, True)]
# K3/K4 extras (n, h, w, c, o, f, stride, pad, thresholds): strided and
# ragged, Cw = 1 (L = 9), O = 16 and 17, N = 1, a 5x5 at stride 2, and
# CONV-6 at batch 1
CONV_EXTRAS = [(2, 9, 9, 64, 40, 3, 2, 1, True),
               (2, 10, 7, 48, 24, 5, 2, 2, False),
               (3, 11, 13, 32, 33, 3, 1, 1, True),
               (2, 12, 12, 32, 16, 3, 1, 1, True),
               (1, 9, 10, 64, 17, 3, 1, 1, False),
               (1, 13, 11, 96, 48, 5, 2, 2, True),
               (1, 8, 8, 512, 512, 3, 1, 1, True)]
# ... and K3's other instantiations (kernels/xnor_conv.py::vpu_plan): the
# generic 16-byte kernel at stride 2 with ragged O and at 5x5 (L = 200,
# rows one TMA copy each), and a Table 2 layout at one tile row, where L is
# split over the block's warps
CONV_EXTRAS += [(2, 9, 9, 128, 40, 3, 2, 1, True),
                (1, 7, 9, 256, 24, 5, 1, 2, True),
                (1, 6, 6, 128, 32, 3, 1, 1, False)]
# K5 extras (n, h, w, c, oa, ob, fa, fb, pool): ragged tile grids, 5x5
# filters, ragged OB; and mxu clusters of C < 8 (OA = 96: C = 3; OA = 64:
# C = 2) with uneven or ragged OB shares (40 over 3: 14/13/13; over 2:
# 20/20), or C = 8 with OB = 200 (25 each), pooled and not, N = 1 and 4
PAIR_EXTRAS = [(2, 10, 6, 32, 32, 32, 3, 3, False),
               (2, 10, 6, 32, 32, 40, 5, 3, True),
               (3, 9, 7, 64, 64, 32, 5, 5, False),
               (2, 8, 8, 32, 32, 32, 5, 5, True)]
PAIR_EXTRAS += [(n, 8, 8, 64, oa, 40, 3, 3, pool) for n in (1, N_SLOTS)
                for oa in (96, 64) for pool in (True, False)]
PAIR_EXTRAS += [(1, 8, 8, 128, 256, 200, 3, 3, True)]
# ... and the vpu kernel's other paths: CwA 4 and OA/32 4 (16-byte units
# outside the compile-time Table 2 geometries), and shares of more than one
# 64-row pass, by TMA and cp.async (OA = 1024: C = 8, 128 conv A rows and
# 65 conv B rows a rank; OA = 352: C = 1, 352 and 100 rows)
PAIR_EXTRAS += [(2, 8, 8, 128, 128, 64, 3, 3, True),
                (1, 4, 4, 128, 1024, 520, 3, 3, True),
                (1, 4, 4, 32, 352, 100, 3, 3, True)]
# XNOR LM (configs/xnor_lm_tiny.py::CONFIG, d 128, d_ff 256, 4 layers):
# K6 calls per decode step by (K, N) — q/k/v/o, up, down in every layer
BW_CALLS = {(128, 128): 16, (128, 256): 4, (256, 128): 4}
# tolerances of tests/test_torch_bw_matmul.py (float32 sum order; one
# bf16 ulp of the rounded output)
BW_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}
# the replica fleet (phase 5): requests of each drive, the Poisson rate
# of the mixed drives, a rate that saturates the fleet, the autoscaled
# run's bulk burst, and the bound on every wait
FLEET_REQUESTS = 512
FLEET_RATE_HZ = 2000.0
FLEET_SATURATE_HZ = 1e6
FLEET_BURST = 4 * FLEET_REQUESTS
FLEET_TIMEOUT_S = 120.0
# the multi-device forwards (phase 5b): batch sizes of the bitwise checks,
# the micro-batches of the stage pipeline and of the data-parallel
# forward, the repeats of each case, the batch sizes timed, and the
# (shards, stages) layouts of the data-parallel forward
MULTI_N = (1, 7, 64, 257)
MULTI_PIPE_MB = (1, 8)
MULTI_DATA_MB = (8, 256)
MULTI_REPEATS = 20
MULTI_TIMED_N = (16, 256, 4096)
MULTI_GRIDS = ((1, 1), (2, 1), (2, 2))
LM_REQUESTS = 16
LM_PROMPT = 8
LM_MAX_NEW = 16
LM_SWAP_AT = 20          # engine steps before the mid-run hot-swap
# K7 at the dense LM's attention (Qwen3-8B: 32 query heads over 8 KV heads,
# hd 128): (B, Hq, Hkv, hd, S, causal); the last S is the main path's
# prefill. The same heads at the simt widths of the zoo's next models (hd
# 96, 112 and 192, where bf16 runs simt too) and at hd 32, which runs in
# simt's 64 bucket. Then ragged extras, both causal settings, at those
# widths; the largest bucket (hd 256, one block an SM in float32); and hd
# 33, whose rows the simt wrapper pads to whole 16-byte units.
FLASH_PATH_S = 4096
FLASH_WIDTHS = (32, 96, 112, 192)
FLASH_CASES = [(1, 32, 8, 128, s, True) for s in (128, 1000, FLASH_PATH_S)]
FLASH_CASES += [(1, 32, 8, hd, FLASH_PATH_S, True) for hd in FLASH_WIDTHS]
FLASH_CASES += [(2, 4, 2, 64, 256, c) for c in (True, False)]
FLASH_CASES += [(1, 2, 1, 64, 200, c) for c in (False, True)]
FLASH_CASES += [(1, 4, 2, hd, 300, True) for hd in FLASH_WIDTHS]
FLASH_CASES += [(1, 2, 1, 256, 200, False), (1, 2, 2, 33, 65, True)]
# the shape K7 simt runs on the main path: the two-layer float32 cut's
# prefill, card vs CPU (DENSE_CPU_TOKENS), timed for the kernels line
FLASH_SIMT_PATH = (2, 32, 8, 128, 256, True)
FLASH_CASES += [FLASH_SIMT_PATH]
# the shape K7 tc runs in every layer of deepseek-v2-lite-16b's prefill at
# S = 4096 (MLA: 16 query heads = 16 KV heads, q and k at qk_nope +
# qk_rope = 192, v at v_head_dim = 128), bf16 only, as the model serves it;
# the batch cell's (8, 16, 16) at S = 1024; and ragged S = 300 with GQA,
# both causal settings (the last 128-row tile and 128-key tile ragged),
# in both dtypes (float32 runs simt on v padded to 192). These rows run v
# at FLASH_MLA_DV, every other row at hd.
FLASH_MLA = (1, 16, 16, 192, FLASH_PATH_S, True)
FLASH_MLA_BATCH = (8, 16, 16, 192, 1024, True)
FLASH_MLA_CASES = [FLASH_MLA, FLASH_MLA_BATCH] + [
    (1, 4, 2, 192, 300, c) for c in (True, False)]
FLASH_MLA_DV = 128
# the "tc" row of the kernels line: the dense LM's prefill
FLASH_TC_PATH = (1, 32, 8, 128, FLASH_PATH_S, True)
# the shapes K7 simt runs on phase 7c's paths, bf16 only, as the models
# serve them: every layer of phi-3-vision-4.2b's prefill (32 query heads =
# 32 KV heads at hd 96) and every application of zamba2-7b's shared block
# (32 = 32 at hd 112), at S = 4096; and phi-3-vision's ragged prefill of
# 576 patches + 4096 text tokens
FLASH_VLM = (1, 32, 32, 96, FLASH_PATH_S, True)
FLASH_HYBRID = (1, 32, 32, 112, FLASH_PATH_S, True)
FLASH_VLM_RAGGED = (1, 32, 32, 96, 576 + FLASH_PATH_S, True)
FLASH_CASES += [FLASH_VLM, FLASH_HYBRID, FLASH_VLM_RAGGED]
# whisper-medium's encoder self-attention: 1500 frames, non-causal, in
# float32 (simt: the served path encodes float32 frames) and bf16 (tc: a
# prefill with bf16 frames; 11.7 tiles of 128 rows, so the last is
# ragged and only the key mask at S keeps the pad keys out)
FLASH_AUDIO = (1, 16, 16, 64, 1500, False)
FLASH_CASES += [FLASH_AUDIO]
FLASH_DTYPES = {c: (torch.bfloat16,)
                for c in (FLASH_MLA, FLASH_MLA_BATCH, FLASH_VLM,
                          FLASH_HYBRID, FLASH_VLM_RAGGED)}
# the reference's prefill_32k length, one sequence: K7 tc vs SDPA
FLASH_LONG = (1, 32, 8, 128, 32768, True)
FLASH_NAMES = {"tc": "flash_attention_tc", "simt": "flash_attention"}
# tolerances of tests/test_torch_flash.py: float32 differs from the plain
# version by the order of its sums (and q scaled before the product, as
# the TPU kernel does; "tc" scales the float32 scores and runs the softmax
# in base 2); in bf16 the kernels round the unnormalised p and
# the plain version p / l, a relative 2**-9 on every weight, which shows
# as an absolute error at the scale of v. So bf16 is allclose at 2e-2, and
# at most FLASH_ULP_SHARE of the elements may differ by more than one bf16
# ulp of max(|plain|, FLASH_ULP_FLOOR).
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
FLASH_ULP_FLOOR = 0.25
FLASH_ULP_SHARE = 0.005
# the dense LM (phase 7)
DENSE_ARCH = "qwen3-8b"
DENSE_CPU_TOKENS = (2, 256)      # the two-layer float32 cut, card vs CPU
DENSE_DECODE_PROMPT = 64         # prefill vs token-by-token decode
DENSE_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE_PREFILL = (1, FLASH_PATH_S)
DENSE_MAX_LEN = 32               # prompt 8 + 16 new tokens fit
# the moe family (phase 7b): DeepSeek-V2-Lite at full width (a 2-layer cut
# card vs CPU, then all 27 layers in bf16, prefilled and served) and
# DeepSeek-V2's 236B config cut to 2 layers at full width. A token whose
# k-th and (k+1)-th router probabilities lie closer than the devices'
# float32 roundings may take another expert set on each device; such a
# position (relative gap (p_k - p_k+1) / p_k below MOE_ROUTE_MARGIN) is
# counted, printed and left out of the logit comparison with the later
# positions of its sequence; a routing difference above the margin fails.
# The 236B cut holds K7 against plain attention on the card in bf16, whose
# roundings move router logits more (tests/test_torch_deepseek.py measured
# swaps at relative gaps 0.014 and 0.021): MOE_BF16_ROUTE_MARGIN there.
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_BIG_ARCH = "deepseek-v2-236b"
MOE_ROUTE_MARGIN = 1e-5
MOE_BF16_ROUTE_MARGIN = 0.05
MOE_DECODE_PROMPT = 8            # <= 8 tokens: no MoE row can drop one
MOE_BIG_PREFILL = (1, 1024)
MOE_BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)
# the vlm, ssm and hybrid families (phase 7c): each model cut in depth at
# full width (card vs the CPU port in float32; prefill vs a decode loop on
# the card), then whole in bf16: prefilled at S = 4096 and served at 4
# slots. zamba2's cut keeps attn_every 6, so two shared-block
# applications; S = 128 takes the recurrences' chunked forms, S = 100
# their token scans. Card vs CPU is held at DENSE_TOL, as phases 7 and 7b
# hold it: the cuts with K7 (float32 simt, whose sums run in another order
# than the plain version's) measured up to 3.3e-05 (phi-3-vision) and
# 1.66e-05 (zamba2) from the CPU port on an H100, rwkv6 (no K7,
# full-width GEMMs alone) 9.3e-06, so the zoo's CPU F32 (1e-5) is below
# what two devices' float32 sums give
RECURRENT_ARCHS = ("phi-3-vision-4.2b", "rwkv6-3b", "zamba2-7b")
RECURRENT_CUT_LAYERS = {"phi-3-vision-4.2b": 2, "rwkv6-3b": 2,
                        "zamba2-7b": 12}
RECURRENT_CUT_S = (128, 100)
RECURRENT_VLM_TEXT = 64          # text tokens after the 576 patches
RECURRENT_DECODE_PROMPT = 64
# K7 launches (all simt) of one full bf16 prefill: one a layer, one a
# shared-block application, none in the attention-free rwkv6
RECURRENT_K7 = {"phi-3-vision-4.2b": 32, "rwkv6-3b": 0, "zamba2-7b": 13}
RECURRENT_REQUESTS = 8
RECURRENT_PROMPT = 16
RECURRENT_NEW = 16
RECURRENT_MAX_LEN = 40           # prompt 16 + 16 new tokens fit
RECURRENT_SWAP_AT = 12           # engine steps before the mid-run swap
# the audio family (phase 7d): whisper-medium cut to 2 encoder and 2
# decoder layers at full width in float32 (card vs CPU port at
# DENSE_TOL; prefill vs a decode loop), then whole in bf16: prefilled at
# S = 4096 on bf16 frames (K7 tc, non-causal in the encoder, causal in
# the decoder), served at 4 slots on float32 frames (the reference's
# engine and CLI pass float32, so admission encodes in float32: K7
# simt) with a mid-run hot-swap, and its packed form (serve/packing.py)
# served at quant binary_weights
AUDIO_ARCH = "whisper-medium"
AUDIO_CUT_LAYERS = 2
AUDIO_CUT_TOKENS = (2, 128)
AUDIO_DECODE_PROMPT = 64
AUDIO_REQUESTS = 8
AUDIO_PROMPT = 16
AUDIO_NEW = 16
AUDIO_MAX_LEN = 40               # prompt 16 + 16 new tokens fit
AUDIO_SWAP_AT = 12               # engine steps before the mid-run swap
# LM training (phase 8b). (a) One make_train_step step card vs CPU from
# the same weights, TF32 off: Qwen3-8B cut to 2 layers at full width in
# float32 at LM_STEP_TOKENS, and the float32 cuts of phases 7b-7d (layers,
# (batch, text tokens)); the loss at rtol 1e-5 and every gradient leaf,
# Adam moment and updated weight within relative L2 1e-4 (float32 sums in
# another order). (b) Qwen3-8B at full width cut to 4 layers, bf16, remat
# on, LM_TRAIN_STEPS steps of (batch, seq) SyntheticLM at lr 3e-4 under
# exact_numerics, straight and crashed after LM_TRAIN_CRASH_AT and
# resumed (checkpoints every LM_TRAIN_CKPT_EVERY, the newest kept);
# (c) its trained weights through K7 tc within relative L2
# LM_TRAIN_K7_GAP of the blockwise path (phase 7's bf16 bar); (d) the cut
# at quant binary_weights trains LM_TRAIN_BW_STEPS steps, is packed and
# served; (e) the CLI on the smoke config.
LM_STEP_TOKENS = (2, 128)
LM_STEP_CUTS = (("deepseek-v2-lite-16b", 2, (2, 128)),
                ("phi-3-vision-4.2b", 2, (1, 64)),
                ("rwkv6-3b", 2, (2, 128)),
                ("zamba2-7b", 12, (2, 64)),
                ("whisper-medium", 2, (2, 128)))
LM_STEP_TOL = {"loss": 1e-5, "leaf": 1e-4}
LM_TRAIN_LAYERS = 4
LM_TRAIN_TOKENS = (8, 1024)
LM_TRAIN_LR = 3e-4
LM_TRAIN_STEPS = 20
LM_TRAIN_CKPT_EVERY = 10
LM_TRAIN_CRASH_AT = 10
LM_TRAIN_BW_STEPS = 10
LM_TRAIN_K7_TOKENS = (2, 1024)
LM_TRAIN_K7_GAP = 0.02
LM_PACKED_PROMPT = (1, 128)
LM_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_lm_train")
# the LM zoo's multi-device forms (phase 9): Qwen3-8B's stage pipeline at
# full depth, bf16 (microbatches of (1, 1024) tokens, stages side by side
# on the card), and its float32 2-layer cut on 2 stages (tokens
# DENSE_CPU_TOKENS, one microbatch a row) against the CPU port
MULTI_LM_STAGES = 4
MULTI_LM_MICRO = 8
MULTI_LM_TOKENS = (1, 1024)
# training (phase 8): the default recipe, the crash step, the card-vs-CPU
# step's tolerances, and where checkpoints and the artifact go (inside
# the checkout, gitignored, removed at the end)
TRAIN_CRASH_AT = 120
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
TRAIN_LM_TOKENS = (2, 64)
# one step on the card vs the CPU from the same state and batch. CONV-1
# and every BN reduce float32 in another order, so a z within rounding of
# 0 may binarize the other way (a few of ~10⁷ decisions); the bounds are
# relative L2 gaps per leaf, which such a flip moves by far less than a
# fault would. Adam's first step moves each weight by lr·sign(g), so a
# gradient within the devices' rounding gap of 0 may move it the other
# way: an updated weight or BN affine may differ (by at most 2·lr) only
# where the two gradients differ in sign or both lie below
# TRAIN_ADAM_FLAT, where u = g / (|g| + eps) is not yet ±1.
TRAIN_STEP_TOL = {"loss": 1e-4, "grads": 1e-3, "moments": 1e-3,
                  "running_stats": 1e-4}
TRAIN_ADAM_FLAT = 1e-6
TRAIN_SAME = 1e-6               # |Δ| of a weight "equal" after the step


def hw() -> dict:
    """The card's data-sheet figures (``launch/dryrun_lib.py::HW``)."""
    from repro_torch.launch.dryrun_lib import HW
    return HW


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one call between CUDA events recorded around it:
    the device work plus whatever the device waits for the host's launch
    (for a call shorter than its Python launch cost, mostly the latter)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


class Bound:
    """Least time for a call: bytes over the HBM rate vs. MACs over the
    compute rate for their type (vpu bit-MACs at the issue rate of the
    carry-save core's instruction mix, int8 MMA for mxu, the bf16
    tensor-core rate for K6's bf16 x ±1 products)."""

    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        clock_mhz = float(smi("clocks.max.sm").split()[0])
        self.sms = props.multi_processor_count
        u = CSA_UNIT
        # SM clocks per unit: the busier of the popc pipe and the ALU pipe
        unit_clk = max(u["popc"] / POPC_PER_CLK_PER_SM,
                       (u["lop3"] + u["iadd3"]) / ALU_PER_CLK_PER_SM)
        self.bitmacs_per_s = {
            "vpu": self.sms * clock_mhz * 1e6 * u["bits"] / unit_clk,
            "mxu": INT8_OPS_PER_S / 2,
            "bf16": hw()["peak_flops"] / 2,
        }
        print(f"bound model: {self.sms} SMs at {clock_mhz:.0f} MHz max SM "
              f"clock; vpu: per 16-byte unit ({u['bits']} bit-MACs) "
              f"{u['lop3']} LOP3 + {u['iadd3']} IADD3 at "
              f"{ALU_PER_CLK_PER_SM} and {u['popc']} POPC at "
              f"{POPC_PER_CLK_PER_SM} a clock per SM -> {unit_clk:.4g} "
              f"clocks, {self.bitmacs_per_s['vpu']:.4g} bit-MAC/s; int8 "
              f"MMA {self.bitmacs_per_s['mxu']:.4g} MAC/s; HBM "
              f"{hw()['hbm_bw']:.3g} B/s")

    def __call__(self, variant: str, nbytes: int, bitmacs: int):
        t_bytes = nbytes / hw()["hbm_bw"] * 1e3
        t_ops = bitmacs / self.bitmacs_per_s[variant] * 1e3
        return t_bytes, t_ops


def device_ms(fn, n: int = 21, per_gate: int | None = None) -> float:
    """Median device time of one call of ``fn``: CUDA events around each of
    ``n`` calls queued behind a sleep kernel (``per_gate`` calls per
    sleep, default all), so the device runs the calls back to back and no
    host launch cost falls inside an interval
    (``kernels/autotune.py::device_times``, which the tuner races)."""
    from repro_torch.kernels.autotune import device_times
    fn()
    torch.cuda.synchronize()
    return statistics.median(device_times(fn, n, per_gate)) * 1e3


def kernel_rows(fn, n: int = 20) -> list[tuple[float, int, str]]:
    """(ms per call, launches per call, name) of every CUDA kernel that
    ``n`` calls of ``fn`` ran, from torch.profiler; [] when the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((t / n / 1e3, ev.count // n, ev.key))
    return sorted(rows, reverse=True)


def kernel_us(fn, name: str, n: int = 20) -> str:
    """The profiler's kernel-only µs per call of ``fn`` for the kernels
    whose name holds ``name``, or "not measured" when it recorded none."""
    rows = [r for r in kernel_rows(fn, n) if name in r[2]]
    if not rows:
        return "not measured"
    return f"{sum(r[0] for r in rows) * 1e3:.3f} µs"


def profile_forward(fwd, x, n: int = 20, stream=None) -> dict:
    """Where one forward's time goes: host wall time per forward, device
    time per forward (``device_ms``), the device's idle share = 1 -
    device / wall, and the kernels by device time (torch.profiler), all
    on ``stream`` (default the current one). Returns wall and device ms,
    the idle share and the profiler's launches per forward (None when it
    recorded no device kernels)."""
    torch.cuda.synchronize()
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        fwd(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fwd(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        busy_ms = device_ms(lambda: fwd(x), n=3)       # ~120 launches each
        rows = kernel_rows(lambda: fwd(x), n)
    print(f"  forward wall {wall_ms:.4f} ms, device {busy_ms:.4f} ms, "
          f"device idle share {1 - busy_ms / wall_ms:.3f}")
    out = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "idle": 1 - busy_ms / wall_ms, "launches": None}
    if not rows:
        print("  per-kernel breakdown: not measured (the profiler recorded "
              "no device kernels)")
        return out
    out["launches"] = sum(r[1] for r in rows)
    print(f"  per-kernel breakdown (torch.profiler): "
          f"{out['launches']} launches, "
          f"{sum(r[0] for r in rows):.4f} ms of kernels per forward")
    for t, count, key in rows[:10]:
        print(f"    {t:.4f} ms  x{count}  {key[:90]}")
    return out


def rand_bits(g, shape, device):
    return torch.randint(0, 2, shape, generator=g, dtype=torch.int8).to(device)


def rand_thr(g, n, k, device):
    c = torch.randint(0, k + 1, (n,), generator=g).to(torch.float32)
    flip = torch.randint(0, 2, (n,), generator=g).to(torch.bool)
    return c.to(device), flip.to(device)


def record(stats, name, got, want, what):
    """Hold an integer kernel output bit-exact against its plain version;
    keep the largest error in ``stats[name]``."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {what}: {got.dtype}{tuple(got.shape)} vs plain "
          f"{want.dtype}{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    check(err == 0, f"{name} {what}: max |kernel - plain| = {err}")


def shifted(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in storage that starts 4 bytes past a 16-byte
    boundary: K1's and K3's wrappers copy such an operand first."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = (-buf.data_ptr() // t.element_size()) % 4 + 1
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def kernel_phase(bound: Bound) -> dict:
    """Phase 2: bit-exact checks and timings of K1-K6 at the path shapes.
    Returns per-kernel sums over one BCNN forward's launches at batch
    N_SLOTS (K6: over one LM decode step)."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_conv as kconv
    from repro_torch.kernels import xnor_matmul as kmm

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    stats = {name: dict(max_abs_err=0, ms=0.0, call_ms=0.0, plain_ms=0.0,
                        t_bytes=0.0, t_ops=0.0, library_ms=0.0)
             for name in SOURCES}

    # --- K1 / K2: FC shapes of the BCNN path, ragged extras, im2col
    # shapes, and the XNOR LM's projections in mode "xnor" (no thresholds;
    # M = 4 per decode step, 16 for the (2, 8) probe forward). Only the
    # BCNN path shapes enter the kernels line; the LM's are summed apart
    # per decode step.
    mm_cases = [(N_SLOTS, n, k, thr, "bcnn") for n, k, thr in FC_SHAPES]
    mm_cases += [(*x, None) for x in MM_EXTRAS]
    mm_cases += [(N_SLOTS * h * h, o, 9 * c, True, "im2col")
                 for h, c, o in CONV_SHAPES]
    mm_cases += [(m, n, k, False, site) for m, site in ((N_SLOTS, "lm"),
                                                          (16, "probe"))
                 for k, n in BW_CALLS]
    lm_step_ms = {"xnor_matmul_vpu": 0.0, "xnor_matmul_mxu": 0.0}
    im2col_ms = {"xnor_matmul_vpu": 0.0, "xnor_matmul_mxu": 0.0}
    for m, n, k, thr, site in mm_cases:
        a = bitpack.pack_bits(bitpack.pad_to_pack(rand_bits(g, (m, k), dev)))
        w = bitpack.pack_bits(bitpack.pad_to_pack(rand_bits(g, (n, k), dev)))
        c, f = rand_thr(g, n, k, dev) if thr else (None, None)

        def plain():
            y = ref.xnor_matmul_ref(a, w, k)
            return ref.norm_binarize_ref(y, c, f) if thr else y

        want = plain()
        a_pm1 = bitpack.decode_pm1(bitpack.unpack_bits(a, k), torch.float16)
        w_pm1t = bitpack.decode_pm1(bitpack.unpack_bits(w, k),
                                    torch.float16).T.contiguous()
        nbytes = a.numel() * 4 + w.numel() * 4 + m * n * (1 if thr else 4)
        nbytes += n * 5 if thr else 0
        k1 = kmm.vpu_plan(m, n, w.shape[1])
        k1_name = "xnor_gemv_kernel" if k1.gemv else "xnor_matmul_vpu_kernel"
        for name, fn in (("xnor_matmul_vpu", kmm.xnor_matmul_vpu),
                         ("xnor_matmul_mxu", kmm.xnor_matmul_mxu)):
            def run(fn=fn):
                return fn(a, w, k=k, thr_c=c, thr_flip=f)
            record(stats, name, run(), want, f"M={m} N={n} k={k} thr={thr}")
            if site is None and name == "xnor_matmul_vpu":
                record(stats, name,
                       fn(shifted(a), shifted(w), k=k, thr_c=c, thr_flip=f),
                       want, f"M={m} N={n} k={k} thr={thr}, operands 4 "
                       f"bytes past 16")
            # K1: its kernel-only time by the profiler at every timed shape
            only = (f", kernel only {kernel_us(run, k1_name)} "
                    f"(torch.profiler)" if name == "xnor_matmul_vpu" else "")
            if site == "lm":
                d = device_ms(run)
                lm_step_ms[name] += BW_CALLS[(k, n)] * d
                print(f"  {name}: {d * 1e3:.2f} µs a call on the device x "
                      f"{BW_CALLS[(k, n)]} per LM decode step{only}")
            if site == "im2col":
                d = device_ms(run)
                im2col_ms[name] += d
                print(f"  {name}: {d * 1e3:.2f} µs a call on the device "
                      f"(im2col shape){only}")
            if site != "bcnn":
                continue
            s = stats[name]
            variant = name.rsplit("_", 1)[1]
            t_b, t_o = bound(variant, nbytes, m * n * k)
            s["t_bytes"] += t_b
            s["t_ops"] += t_o
            d = device_ms(run)
            s["ms"] += d
            s["call_ms"] += time_ms(run)
            print(f"  {name}: {d * 1e3:.2f} µs a call on the device, bound "
                  f"{max(t_b, t_o) * 1e3:.3g} µs{only}")
            s["plain_ms"] += device_ms(plain)
            s["library_ms"] += device_ms(lambda: a_pm1 @ w_pm1t)
        where = {"bcnn": " (BCNN path shape)", "lm": " (LM decode shape)",
                 "probe": " (LM probe shape)", "im2col": " (im2col shape)",
                 None: ""}[site]
        plan = kmm.mxu_plan(m, n, w.shape[1])
        k1_line = (f"GEMV, row tile {k1.mt}, {1 << k1.lg} lanes a weight row"
                   if k1.gemv else f"tiles 32 x {k1.bm}, "
                   f"{len(k1.passes())} pass(es) of K, {k1.smem} B shared")
        print(f"K1/K2 bit-exact vs plain at M={m} N={n} k={k} "
              f"thresholds={thr}{where}; K1 plan: {k1_line}, "
              f"{'16' if k1.vec == 4 else '4'}-byte units, {k1.blocks} "
              f"blocks; K2 plan: tile {plan.bn} x "
              f"{plan.bm}, cluster {plan.cs}, {plan.blocks} blocks, "
              f"{plan.smem} B shared")
    print("K1/K2 per LM decode step in mode xnor (24 calls, not in the "
          "kernels line): " + ", ".join(f"{k} {v:.4f} ms on the device"
                                        for k, v in lm_step_ms.items()))
    print("K1/K2 over the im2col shapes of CONV-2..6 at batch "
          f"{N_SLOTS} (not in the kernels line): " + ", ".join(
              f"{k} {v:.4f} ms on the device" for k, v in im2col_ms.items()))

    # --- K3 / K4: the five binary convs, plus strided / ragged extras
    cv_cases = [(N_SLOTS, h, h, c, o, 3, 1, 1, True, True)
                for h, c, o in CONV_SHAPES]
    cv_cases += [(N_SLOTS, h, h, c, o, 3, 1, 1, False, False)
                 for h, c, o in CONV_SHAPES[::2]]
    cv_cases += [(*x, False) for x in CONV_EXTRAS]
    for n, h, wd, c, o, f, s_, p, thr, on_path in cv_cases:
        a_bits = rand_bits(g, (n, h, wd, c), dev)
        w_bits = rand_bits(g, (o, f, f, c), dev)
        aw = bitpack.pack_bits(bitpack.pad_to_pack(a_bits))
        ww = kconv.pack_conv_weights(bitpack.decode_pm1(w_bits))
        k = f * f * c
        th, fl = rand_thr(g, o, k, dev) if thr else (None, None)

        def plain():
            y = ref.xnor_conv2d_ref(a_bits, w_bits, stride=s_, pad=p)
            return ref.norm_binarize_ref(y, th, fl) if thr else y

        want = plain()
        ho = (h + 2 * p - f) // s_ + 1
        wo = (wd + 2 * p - f) // s_ + 1
        a16 = bitpack.decode_pm1(a_bits, torch.float16).permute(
            0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        w16 = bitpack.decode_pm1(w_bits, torch.float16).permute(
            0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        nbytes = aw.numel() * 4 + ww.numel() * 4
        nbytes += n * ho * wo * o * (1 if thr else 4) + (o * 5 if thr else 0)
        for name, fn in (("xnor_conv2d_vpu", kconv.xnor_conv2d_vpu),
                         ("xnor_conv2d_mxu", kconv.xnor_conv2d_mxu)):
            def run(fn=fn):
                return fn(aw, ww, k=k, fh=f, fw=f, stride=s_, pad=(p, p),
                          thr_c=th, thr_flip=fl)
            record(stats, name, run(), want, f"N={n} {h}x{wd} C={c} O={o} "
                   f"{f}x{f}/s{s_} thr={thr}")
            if not on_path and name == "xnor_conv2d_vpu":
                record(stats, name,
                       fn(shifted(aw), shifted(ww), k=k, fh=f, fw=f,
                          stride=s_, pad=(p, p), thr_c=th, thr_flip=fl),
                       want, f"N={n} {h}x{wd} C={c} O={o} {f}x{f}/s{s_} "
                       f"thr={thr}, operands 4 bytes past 16")
            if not on_path:
                continue
            st = stats[name]
            variant = name.rsplit("_", 1)[1]
            t_b, t_o = bound(variant, nbytes, n * ho * wo * o * k)
            st["t_bytes"] += t_b
            st["t_ops"] += t_o
            d = device_ms(run)
            st["ms"] += d
            st["call_ms"] += time_ms(run)
            only = (f", kernel only {kernel_us(run, 'xnor_conv2d_vpu_kernel')}"
                    f" (torch.profiler)" if name == "xnor_conv2d_vpu" else "")
            print(f"  {name}: {d * 1e3:.2f} µs a call on the device, bound "
                  f"{max(t_b, t_o) * 1e3:.3g} µs{only}")
            st["plain_ms"] += device_ms(plain)
            st["library_ms"] += device_ms(lambda: torch.nn.functional.conv2d(
                a16, w16, stride=s_, padding=p))
        plan = kconv.mxu_plan(n, ho, wo, aw.shape[3], o, f, f, s_)
        k3 = kconv.vpu_plan(n, ho, wo, aw.shape[3], o, f, f, s_)
        print(f"K3/K4 bit-exact vs plain at N={n} {h}x{wd} C={c} O={o} "
              f"{f}x{f} stride {s_} thresholds={thr}"
              f"{' (path shape)' if on_path else ''}; K3 plan: {k3.th} x 8 "
              f"positions x {kconv.K3_BO} channels, {k3.vec * 4}-byte units, "
              f"L split {k3.ks} ways, {k3.blocks} blocks, {k3.smem} B shared;"
              f" K4 plan: {plan.th} x "
              f"8 positions x {plan.bo} channels, L split {plan.ks} ways, "
              f"{plan.blocks} blocks, {plan.smem} B shared")

    pair_phase(g, dev, bound, stats)
    bw_phase(g, dev, bound, stats["binary_weight_matmul"])
    simt_plan_phase()
    flash_phase(g, dev, stats)

    for name, s in stats.items():
        s["bound_ms"] = max(s["t_bytes"], s["t_ops"])
        s["bound_by"] = "bytes" if s["t_bytes"] >= s["t_ops"] else "operations"
        lib = ("two cuDNN fp16 convs + max_pool2d" if "pair" in name
               else "torch.mm bf16 -> f32" if name == "binary_weight_matmul"
               else "SDPA bf16" if name == FLASH_NAMES["tc"]
               else "SDPA float32" if name == FLASH_NAMES["simt"]
               else "library")
        per = ("LM decode step at 4 slots" if name == "binary_weight_matmul"
               else f"call at (1, 32, 8, 128), S = {FLASH_PATH_S}, bf16 "
               f"views" if name == FLASH_NAMES["tc"]
               else f"call at (B, Hq, Hkv, hd, S, causal) = "
               f"{FLASH_SIMT_PATH}, float32" if name == FLASH_NAMES["simt"]
               else f"forward at batch {N_SLOTS}")
        print(f"{name}: per {per}: kernel "
              f"{s['ms']:.4f} ms on the device ({s['call_ms']:.4f} ms per "
              f"call with the host launch), bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']}), plain {s['plain_ms']:.4f} ms, {lib} "
              f"{s['library_ms']:.4f} ms")
    return stats


def pair_phase(g, dev, bound: Bound, stats: dict) -> None:
    """K5 (``xnor_conv2d_pair_vpu`` / ``_mxu``) against its plain version,
    bit-exact: both Table 2 pairs at every legal tile, then ``PAIR_EXTRAS``
    (ragged tile grids, 5×5 filters, ragged OB, and clusters of C < 8 or
    uneven OB shares for mxu). Prints the mxu cluster split of every case.
    At the path pairs, sums each variant's device time at the default
    tile into ``stats`` and times mxu at every legal tile."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import autotune
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_conv as kconv
    from repro_torch.kernels import xnor_conv_fused as kfused

    best = {"xnor_conv2d_pair_vpu": 0.0, "xnor_conv2d_pair_mxu": 0.0}
    pr_cases = [(N_SLOTS, h, h, c, oa, ob, 3, 3, True, True)
                for h, c, oa, ob in PAIR_SHAPES]
    pr_cases += [(*x, False) for x in PAIR_EXTRAS]
    for n, h, wd, c, oa, ob, fa, fb, pool, on_path in pr_cases:
        a_bits = rand_bits(g, (n, h, wd, c), dev)
        wa_bits = rand_bits(g, (oa, fa, fa, c), dev)
        wb_bits = rand_bits(g, (ob, fb, fb, oa), dev)
        ka, kb = fa * fa * c, fb * fb * oa
        ca, fla = rand_thr(g, oa, ka, dev)
        cb, flb = rand_thr(g, ob, kb, dev)
        thr = dict(thr_a_c=ca, thr_a_flip=fla, thr_b_c=cb, thr_b_flip=flb)

        def plain():
            return ref.xnor_conv2d_pair_ref(a_bits, wa_bits, wb_bits,
                                            pool_b=pool, **thr)

        want = plain()
        aw = bitpack.pack_bits(a_bits)
        waw = kconv.pack_conv_weights(bitpack.decode_pm1(wa_bits))
        wbw = kconv.pack_conv_weights(bitpack.decode_pm1(wb_bits))
        pf = 2 if pool else 1
        geom = dict(pf=pf, fha=fa, fwa=fa, cwa=c // 32, fhb=fb, fwb=fb, oa=oa)
        tiles = autotune.tile_candidates(h // pf, wd // pf, **geom)
        if not on_path:
            tiles = tuple(t for t in ((4, 4), (1, 2), (2, 2)) if t in tiles)
        path_tile = kfused.pick_tiles(h // pf, wd // pf, **geom)
        case = (f"N={n} {h}x{wd} C={c} OA={oa} OB={ob} {fa}x{fa}/{fb}x{fb} "
                f"pool={pool}")
        csize, _, ob_split = kfused.mxu_split(oa, ob)
        for name, fn in (("xnor_conv2d_pair_vpu", kfused.xnor_conv2d_pair_vpu),
                         ("xnor_conv2d_pair_mxu", kfused.xnor_conv2d_pair_mxu)):
            def run(fn=fn, tile=path_tile):
                return fn(aw, waw, wbw, ka=ka, kb=kb, fha=fa, fwa=fa, fhb=fb,
                          fwb=fb, pool=pool, th=tile[0], tw=tile[1], **thr)
            for tile in tiles:
                record(stats, name, run(tile=tile), want,
                       f"{case} tile={tile}")
            if not on_path:
                continue
            st = stats[name]
            variant = name.rsplit("_", 1)[1]
            nbytes = (aw.numel() + waw.numel() + wbw.numel()) * 4
            nbytes += want.numel() + (oa + ob) * 5
            # bit-MACs of conv A over the real map and of conv B, each
            # counted once (the kernel's halo recompute is not work the
            # function needs)
            t_b, t_o = bound(variant, nbytes,
                             n * h * wd * (oa * ka + ob * kb))
            st["t_bytes"] += t_b
            st["t_ops"] += t_o
            d = device_ms(run)
            st["ms"] += d
            st["call_ms"] += time_ms(run)
            print(f"  {name} at the path tile {path_tile}: {d:.4g} ms on "
                  f"the device, bound {max(t_b, t_o):.4g} ms")
            per_tile = {t: device_ms(lambda t=t: run(tile=t)) for t in tiles}
            best[name] += min(per_tile.values())
            print(f"  {name} {case}, device ms per tile (cluster of "
                  f"{csize}): " + ", ".join(f"{t} {v:.4g}"
                                           for t, v in per_tile.items()))
            print(f"  {name} at the path tile {path_tile}: kernel only "
                  f"{kernel_us(run, 'pair_' + variant)} per call "
                  f"(torch.profiler)")
            st["plain_ms"] += device_ms(plain)
            a16 = bitpack.decode_pm1(a_bits, torch.float16).permute(
                0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            mid16 = bitpack.decode_pm1(
                ref.norm_binarize_ref(ref.xnor_conv2d_ref(a_bits, wa_bits),
                                      ca, fla), torch.float16).permute(
                0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            wa16, wb16 = (bitpack.decode_pm1(t, torch.float16).permute(
                0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                for t in (wa_bits, wb_bits))

            def library():      # yardstick: two cuDNN convs + a max-pool
                torch.nn.functional.conv2d(a16, wa16, padding=fa // 2)
                return torch.nn.functional.max_pool2d(
                    torch.nn.functional.conv2d(mid16, wb16,
                                               padding=fb // 2), 2)
            st["library_ms"] += device_ms(library)
        print(f"K5 vpu and mxu bit-exact vs plain at {case}, tiles "
              f"{list(tiles)}; both in clusters of {csize}, OB shares "
              f"{sorted({hi - lo for lo, hi in ob_split})}, vpu "
              f"{kfused.halo_scratch(*path_tile, variant='vpu', **geom)} B "
              f"shared at tile {path_tile}"
              f"{' (path shape)' if on_path else ''}")
    print("K5 over the two path pairs at batch "
          f"{N_SLOTS}, each pair at its fastest tile (default tiles in the "
          f"kernels line): " + ", ".join(f"{k} {v:.4f} ms on the device"
                                         for k, v in best.items()))


def bw_phase(g, dev, bound: Bound, st: dict) -> None:
    """K6 at the XNOR LM's shapes: M = 4 (decode over 4 slots), 16 and 128
    (prefill rows), (K, N) of every projection, plus ragged extras.
    ±1 float32 activations must equal the plain version exactly; real
    float32 / bfloat16 activations with a scale must be allclose at
    ``BW_TOL``. Times are summed over one decode step's calls (M = 4)."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_matmul as kmm

    cases = [(m, k, n, m == N_SLOTS) for m in (N_SLOTS, 16, 128)
             for k, n in BW_CALLS]
    cases += [(5, 40, 33, False), (37, 1100, 77, False)]
    real_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, k, n, on_path in cases:
        w = bitpack.pack_pm1(torch.randn((n, k), generator=g)).to(dev)
        kp = w.shape[1] * 32
        a = torch.nn.functional.pad(
            bitpack.decode_pm1(rand_bits(g, (m, k), dev)), (0, kp - k))

        def run(a=a):
            return kmm.binary_weight_matmul(a, w)

        def plain(a=a):
            return ref.binary_weight_matmul_ref(a, w)

        got, want = run(), plain()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"binary_weight_matmul M={m} K={k} N={n}: {got.dtype}"
              f"{tuple(got.shape)} vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got - want).abs().max())
        st["max_abs_err"] = max(st["max_abs_err"], err)
        check(err == 0, f"binary_weight_matmul ±1 M={m} K={k} N={n}: max "
              f"|kernel - plain| = {err}")
        scale = (torch.rand(n, generator=g) + 0.5).to(dev)
        for dt, tol in BW_TOL.items():
            ar = torch.nn.functional.pad(
                torch.randn((m, k), generator=g).to(dev, dt), (0, kp - k))
            got = kmm.binary_weight_matmul(ar, w, scale=scale)
            want = ref.binary_weight_matmul_ref(ar, w, scale)
            check(got.dtype == dt and torch.allclose(
                got.float(), want.float(), **tol),
                f"binary_weight_matmul {dt} M={m} K={k} N={n}: max "
                f"|kernel - plain| = {(got.float() - want.float()).abs().max()}")
            real_err[dt] = max(real_err[dt],
                               float((got.float() - want.float()).abs().max()))
        plan = kmm.bw_plan(m, n, w.shape[1])
        print(f"K6 vs plain at M={m} K={k} N={n}: ±1 bit-exact, real "
              f"float32 / bfloat16 with scale allclose; grid {plan.grid} "
              f"of one warp, row tile {plan.mt}"
              f"{' (path shape)' if on_path else ''}")
        d = device_ms(run)
        if (k, n) not in BW_CALLS:
            print(f"  binary_weight_matmul M={m} K={k} N={n}: {d:.4g} ms on "
                  f"the device")
            continue
        a16 = a.to(torch.bfloat16)
        w16t = bitpack.decode_pm1(bitpack.unpack_bits(w),
                                  torch.bfloat16).T.contiguous()

        def library():
            return torch.mm(a16, w16t, out_dtype=torch.float32)

        lib = device_ms(library)
        print(f"  binary_weight_matmul M={m} K={k} N={n}: {d:.4g} ms on the "
              f"device, torch.mm bf16 -> f32 {lib:.4g} ms; kernel only "
              f"{kernel_us(run, 'binary_weight_matmul')} vs torch.mm "
              f"{kernel_us(library, '')} per call (torch.profiler)")
        if not on_path:
            continue
        calls = BW_CALLS[(k, n)]
        t_b, t_o = bound("bf16", a.numel() * 4 + w.numel() * 4 + m * n * 4,
                         m * n * k)
        st["t_bytes"] += calls * t_b
        st["t_ops"] += calls * t_o
        st["ms"] += calls * d
        st["call_ms"] += calls * time_ms(run)
        st["plain_ms"] += calls * device_ms(plain)
        st["library_ms"] += calls * lib
        print(f"  binary_weight_matmul: {d:.4g} ms on the device x {calls} "
              f"per decode step, bound {max(t_b, t_o):.4g} ms")
    print(f"K6 real-activation max |kernel - plain|: float32 "
          f"{real_err[torch.float32]:.3g}, bfloat16 "
          f"{real_err[torch.bfloat16]:.3g}")


def flash_bound(b, hq, hkv, hd, s, causal, dtype, dv=None):
    """(bytes ms, operations ms) of one attention call with v (and O) at
    width ``dv`` (default hd): Q, K and V read once, O written once, at the
    HBM rate; 2·B·Hq·(hd + dv) FLOP per kept (query, key) pair (S(S+1)/2
    of them when causal) at the dense tensor-core rate of bf16, or at the
    float32 CUDA-core rate (67 TFLOP/s) for float32."""
    dv = hd if dv is None else dv
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (b * hq + b * hkv) * s * (hd + dv) * esize
    kept = s * (s + 1) // 2 if causal else s * s
    rate = hw()["peak_flops"] if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return (nbytes / hw()["hbm_bw"] * 1e3,
            2 * b * hq * (hd + dv) * kept / rate * 1e3)


def ulp_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of elements off by more than one bf16 ulp of
    max(|want|, FLASH_ULP_FLOOR)."""
    mag = want.float().abs().clamp(min=FLASH_ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want.float()).abs() > ulp).float().mean())


def flash_check(got, want, dt, what: str) -> tuple[float, float]:
    """Hold one K7 output against ``want`` at ``FLASH_TOL`` (bf16: and at
    most FLASH_ULP_SHARE of the elements beyond one ulp); returns (max
    |err|, share beyond one ulp)."""
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == dt and got.shape == want.shape
          and bool(got.isfinite().all()),
          f"{what}: {got.dtype}{tuple(got.shape)} or not finite")
    check(torch.allclose(got.float(), want.float(), **FLASH_TOL[dt]),
          f"{what}: max |kernel - reference| = {err:.3g}")
    share = ulp_share(got, want) if dt == torch.bfloat16 else 0.0
    check(share <= FLASH_ULP_SHARE,
          f"{what}: {share:.4f} of elements off by more than one bf16 ulp")
    return err, share


def simt_plan_phase() -> None:
    """The K7 "simt" plan of every hd bucket in both dtypes, read from
    the card (``kfa.simt_plan``) and held against its Python mirror; 2
    blocks an SM are required at hd <= 128 in float32."""
    from repro_torch.kernels import flash_attention as kfa
    for dt in (torch.float32, torch.bfloat16):
        for hd in kfa.SIMT_HEAD_DIMS:
            p = kfa.simt_plan(hd, dt)
            check(p["smem"] == kfa.simt_smem_bytes(hd, dt)
                  and p["kv_tile"] == kfa.simt_kv_tile(hd, dt)
                  and p["bucket"] == hd,
                  f"K7 simt plan {p} at hd {hd} {dt} disagrees with "
                  f"its Python mirror")
            print(f"K7 simt plan at hd {hd}, {str(dt)[6:]}: "
                  f"{p['blocks_per_sm']} blocks an SM (occupancy API), "
                  f"{p['registers']} registers, {p['local_bytes']} local "
                  f"(spill) bytes a thread, {p['smem']} B shared, "
                  f"{p['kv_tile']}-key tiles")
            if dt == torch.float32 and hd <= 128:
                check(p["blocks_per_sm"] >= 2,
                      f"K7 simt holds {p['blocks_per_sm']} block(s) an SM "
                      f"at hd {hd} float32, not 2")


def flash_phase(g, dev, stats: dict) -> None:
    """K7 against its plain version on every ``FLASH_CASES`` row, float32
    and bfloat16, at ``FLASH_TOL``, in the variant ``pick_variant``
    chooses, read back from the launch counters. A "tc" row is held twice:
    on contiguous tensors, and on head-major views ``x.transpose(1, 2)``
    of (B, S, H, hd) tensors, the layout ``gqa_forward`` hands over, which
    the kernel's tensor maps read in place. v has width ``FLASH_MLA_DV``
    on the ``FLASH_MLA_CASES`` rows, else hd. Times every row (on the views
    where the variant is "tc") beside the plain version and SDPA on the
    same inputs; the kernels line takes "tc" at ``FLASH_TC_PATH`` in bf16
    and "simt" at ``FLASH_SIMT_PATH`` in float32. Then "tc" at
    ``FLASH_LONG`` against SDPA's output, at the same tolerances. Uses no
    more of the package than the wrapper, its launch counters and the
    plain version, so it runs on an older checkout's ``src`` too."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    rows = ([(c, c[3]) for c in FLASH_CASES]
            + [(c, FLASH_MLA_DV) for c in FLASH_MLA_CASES])
    for (b, hq, hkv, hd, s, causal), dv in rows:
        for dt in FLASH_DTYPES.get((b, hq, hkv, hd, s, causal),
                                   (torch.float32, torch.bfloat16)):
            picked = kfa.pick_variant(dt, hd, dv)
            name = FLASH_NAMES[picked]
            case = (f"(B, Hq, Hkv, hd) = {(b, hq, hkv, hd)}"
                    + (f", v at {dv}" if dv != hd else "")
                    + f", S = {s}, causal = {causal}, {str(dt)[6:]}")
            layouts = ["contiguous"] + (["views"] if picked == "tc" else [])
            for layout in layouts:
                if layout == "views":
                    q, k, v = (torch.randn((b, s, h, w), generator=g).to(
                        dev, dt).transpose(1, 2)
                        for h, w in ((hq, hd), (hkv, hd), (hkv, dv)))
                    check(kfa.tma_ready(q) and not q.is_contiguous(),
                          f"K7 {case}: the views are not read in place")
                else:
                    q, k, v = (torch.randn((b, h, s, w), generator=g).to(
                        dev, dt)
                        for h, w in ((hq, hd), (hkv, hd), (hkv, dv)))
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                n_tc = kfa.flash_attention.launches_tc
                got = kfa.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                ran = ("tc" if kfa.flash_attention.launches_tc > n_tc
                       else "simt")
                check(ran == picked, f"K7 {case} launched {ran}, "
                      f"pick_variant says {picked}")
                err, share = flash_check(got, want, dt,
                                         f"{name} {case} ({layout})")
                stats[name]["max_abs_err"] = max(
                    stats[name]["max_abs_err"], err)
                line = (f"K7 at {case}, {layout}: {picked} (launch "
                        f"counters), vs plain max |err| {err:.3g}"
                        + (f", {share:.5f} beyond one ulp"
                           if dt == torch.bfloat16 else ""))
                if layout != layouts[-1]:
                    print(line)
                    del got, want, q, k, v
                    continue

                def run():
                    return kfa.flash_attention(q, k, v, causal=causal)
                t_b, t_o = flash_bound(b, hq, hkv, hd, s, causal, dt, dv)
                d = device_ms(run)
                plain_ms = device_ms(
                    lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                    n=5)
                lib_ms = device_ms(lambda: sdpa(
                    q, k, v, is_causal=causal, enable_gqa=True))
                print(f"{line}; {name} {d:.4g} ms on the device, bound "
                      f"{max(t_b, t_o):.4g} ms (bytes {t_b:.4g}, operations "
                      f"{t_o:.4g}), plain {plain_ms:.4g} ms, SDPA "
                      f"{lib_ms:.4g} ms")
                if (b, hq, hkv, hd, s, causal) == (
                        FLASH_TC_PATH if picked == "tc" else FLASH_SIMT_PATH):
                    stats[name].update(
                        ms=d, call_ms=time_ms(run, reps=10),
                        plain_ms=plain_ms, library_ms=lib_ms, t_bytes=t_b,
                        t_ops=t_o)
                del got, want, q, k, v
            torch.cuda.empty_cache()

    b, hq, hkv, hd, s, causal = FLASH_LONG
    q, k, v = (torch.randn((b, h, s, hd), generator=g).to(dev, torch.bfloat16)
               for h in (hq, hkv, hkv))
    n_tc = kfa.flash_attention.launches_tc

    def run():
        return kfa.flash_attention(q, k, v, causal=causal)

    def library():
        return sdpa(q, k, v, is_causal=causal, enable_gqa=True)

    got, want = run(), library()
    torch.cuda.synchronize()
    check(kfa.flash_attention.launches_tc == n_tc + 1,
          f"K7 at {FLASH_LONG} did not launch tc")
    err, share = flash_check(got, want, torch.bfloat16,
                             f"flash_attention_tc {FLASH_LONG} vs SDPA")
    del got, want
    t_b, t_o = flash_bound(b, hq, hkv, hd, s, causal, torch.bfloat16)
    d, lib_ms = device_ms(run, n=7), device_ms(library, n=7)
    print(f"K7 tc at {FLASH_LONG} (prefill_32k, one sequence) vs SDPA: max "
          f"|err| {err:.3g}, {share:.5f} beyond one ulp; {d:.4g} ms on the "
          f"device, bound {max(t_b, t_o):.4g} ms (operations {t_o:.4g}), "
          f"SDPA {lib_ms:.4g} ms")
    del q, k, v
    torch.cuda.empty_cache()


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    entry = ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else ""
        if "Used" in line or "spill" in line or "error" in line:
            print(f"  nvcc: {line.strip()}")
            simt = re.search(r"flash_simt_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                             entry)
            if simt:
                print(f"  nvcc flash_simt_kernel<"
                      f"{'float' if simt[1] == 'f' else 'bf16'}, hd "
                      f"{simt[2]}>: {line.strip()}")
            for kernel in ("xnor_matmul_mxu_kernel", "xnor_conv2d_mxu_kernel",
                           "pair_vpu_kernel", "binary_weight_matmul_kernel",
                           "xnor_gemv_kernel", "xnor_matmul_vpu_kernel",
                           "xnor_conv2d_vpu_kernel"):
                if kernel in entry:
                    print(f"  nvcc {kernel}: {line.strip()}")


def probe_phase() -> None:
    """The tensor-core rate probe: bit-MACs per second of each MMA form,
    beside the SM clock sampled just after and the power limit."""
    from repro_torch.kernels import mma_probe
    rates = mma_probe.rates()
    clock = smi("clocks.sm")
    print(f"mma rate probe ({smi('name,power.limit')}, SM clock {clock} "
          f"after the run): " + ", ".join(
              f"{name} {r:.4g} bit-MAC/s" for name, r in rates.items())
          + f"; fastest: {max(rates, key=rates.get)} (K2 and K4 use "
          f"b1 and.popc)")


def cpu_reference():
    """The served images, the packed net on the CPU, every layer's CPU
    input/output and the logits of the port's plain path."""
    from repro_torch.core import bcnn
    from repro_torch.core import execution_plan as xp
    from repro_torch.data.synthetic import SyntheticImages
    x_np, _ = SyntheticImages(global_batch=N_REQUESTS, seed=SEED).batch(0)
    x_cpu = torch.from_numpy(x_np)
    packed_cpu = bcnn.fold_model(bcnn.params_from_numpy(
        bcnn.numpy_params(SEED)))
    cpu_plan = xp.build_plan(packed_cpu, path="xla", device="cpu")
    hs = [x_cpu]
    for idx in range(bcnn.N_LAYERS):
        hs.append(bcnn.apply_packed_layer(packed_cpu, idx, hs[-1],
                                          plan=cpu_plan))
    logits_cpu = hs[-1].numpy()
    check(logits_cpu.shape == (N_REQUESTS, 10)
          and np.isfinite(logits_cpu).all(), "CPU logits malformed")
    return x_np, packed_cpu, hs, logits_cpu


def serve(eng, x_np, logits_cpu, tag: str):
    """Serve ``x_np`` through ``eng`` (warmed up by the caller); hold the
    logits against the CPU port (allclose 1e-5, equal argmax). Returns
    the number of forwards and the served logits."""
    steps0 = eng.steps_executed
    t0 = time.perf_counter()
    rids = [eng.submit(img) for img in x_np]
    out = eng.run()
    dt = time.perf_counter() - t0
    check(sorted(out) == sorted(rids), f"[{tag}] requests lost")
    logits = np.stack([out[r] for r in rids])
    check(np.isfinite(logits).all() and logits.shape == (N_REQUESTS, 10),
          f"[{tag}] served logits malformed")
    check(np.allclose(logits, logits_cpu, rtol=1e-5, atol=1e-5),
          f"[{tag}] served logits differ from the CPU port: max "
          f"{np.abs(logits - logits_cpu).max():.3g}")
    check((logits.argmax(1) == logits_cpu.argmax(1)).all(),
          f"[{tag}] argmax differs from the CPU port")
    st = eng.stats(last_n=N_REQUESTS)
    print(f"[{tag}] served {st['n']} requests through {N_SLOTS} slots "
          f"in {dt * 1e3:.1f} ms: latency p50 {st['p50'] * 1e3:.3f} ms, "
          f"p99 {st['p99'] * 1e3:.3f} ms, {st['throughput']:.1f} img/s; "
          f"logits max |gpu - cpu| {np.abs(logits - logits_cpu).max():.3g}")
    return eng.steps_executed - steps0, logits


def eager_logits(fwd, x_np) -> np.ndarray:
    """The card's eager ``forward_packed`` of ``fwd``'s current weights
    and plan on ``x_np``, at the served batch of ``N_SLOTS`` images."""
    from repro_torch.core import bcnn
    torch.cuda.synchronize()
    outs = [bcnn.forward_packed(
        fwd.packed, torch.from_numpy(x_np[i:i + N_SLOTS]).cuda(),
        plan=fwd.plan).cpu().numpy() for i in range(0, len(x_np), N_SLOTS)]
    return np.concatenate(outs)


def graph_checks(eng, tag, x_np, served, packed_a, packed_b,
                 logits_cpu_b) -> None:
    """The captured step of ``eng`` (warmed, serving ``packed_a``):
    served logits bitwise equal to the eager card forward, an occupancy
    sweep 1..N_SLOTS on one graph, a hot-swap to ``packed_b`` mid-run
    (queued requests get the new weights, bitwise equal to its eager card
    forward and allclose to the CPU port; no new capture; every weight
    keeps its storage), then a swap back to ``packed_a``."""
    from repro_torch.core import bcnn
    fwd = eng.forward
    ptrs = [t.data_ptr() for t in bcnn.split_packed(fwd.packed)[0]]
    eager_a = eager_logits(fwd, x_np)
    check(np.array_equal(served, eager_a), f"[{tag}] replayed logits differ "
          f"from the eager card forward: max "
          f"{np.abs(served - eager_a).max():.3g}")
    for k in range(1, N_SLOTS + 1):
        rids = [eng.submit(img) for img in x_np[:k]]
        out = eng.run()
        check(np.array_equal(np.stack([out[r] for r in rids]), eager_a[:k]),
              f"[{tag}] occupancy {k}: replayed logits differ from eager")
    check(eng.step_cache_size == 1, f"[{tag}] step_cache_size "
          f"{eng.step_cache_size} after the occupancy sweep")
    rids = [eng.submit(img) for img in x_np]
    n_old = 2 * N_SLOTS
    first = eng.run(max_steps=2)
    drained = eng.swap_packed(packed_b)
    rest = eng.run()
    check(drained == {} and sorted(first) == rids[:n_old]
          and sorted(rest) == rids[n_old:],
          f"[{tag}] swap: requests lost or served out of order")
    eager_b = eager_logits(fwd, x_np)
    got_a = np.stack([first[r] for r in rids[:n_old]])
    got_b = np.stack([rest[r] for r in rids[n_old:]])
    check(np.array_equal(got_a, eager_a[:n_old]),
          f"[{tag}] swap: pre-swap logits differ from eager")
    check(np.array_equal(got_b, eager_b[n_old:]),
          f"[{tag}] swap: post-swap replayed logits differ from the eager "
          f"card forward of the new net")
    check(np.allclose(eager_b, logits_cpu_b, rtol=1e-5, atol=1e-5)
          and (eager_b.argmax(1) == logits_cpu_b.argmax(1)).all(),
          f"[{tag}] swap: new net's logits differ from the CPU port: max "
          f"{np.abs(eager_b - logits_cpu_b).max():.3g}")
    check(not np.array_equal(eager_a, eager_b),
          f"[{tag}] swap changed no logit")
    check(eng.step_cache_size == 1 and ptrs == [
        t.data_ptr() for t in bcnn.split_packed(fwd.packed)[0]],
        f"[{tag}] swap: a new capture or a weight changed storage")
    eng.swap_packed(packed_a)
    rids = [eng.submit(img) for img in x_np]
    out = eng.run()
    check(np.array_equal(np.stack([out[r] for r in rids]), eager_a)
          and eng.step_cache_size == 1,
          f"[{tag}] swap back: logits differ from the first net's")
    print(f"[{tag}] one CUDA graph (step_cache_size {eng.step_cache_size}) "
          f"over occupancies 1..{N_SLOTS} and two swaps: replayed logits "
          f"bitwise equal to the eager card forward before and after "
          f"swap_packed, the new net's allclose to the CPU port (max "
          f"{np.abs(eager_b - logits_cpu_b).max():.3g}); all {len(ptrs)} "
          f"weight tensors kept their storage")


def bcnn_counters() -> dict:
    """The launch counters of the BCNN's kernels, by kernel name."""
    from repro_torch.kernels import xnor_conv as kconv
    from repro_torch.kernels import xnor_conv_fused as kfused
    from repro_torch.kernels import xnor_matmul as kmm
    return {"xnor_matmul_vpu": kmm.xnor_matmul_vpu,
            "xnor_matmul_mxu": kmm.xnor_matmul_mxu,
            "xnor_conv2d_vpu": kconv.xnor_conv2d_vpu,
            "xnor_conv2d_mxu": kconv.xnor_conv2d_mxu,
            "xnor_conv2d_pair_vpu": kfused.xnor_conv2d_pair_vpu,
            "xnor_conv2d_pair_mxu": kfused.xnor_conv2d_pair_mxu}


def forward_launches(plan) -> dict:
    """Kernel launches of one forward under ``plan``, by kernel name."""
    want = {f"xnor_conv2d_{plan.path}": 1 if plan.conv_fusion else 5,
            f"xnor_matmul_{plan.path}": 3}
    if plan.conv_fusion:
        want[f"xnor_conv2d_pair_{plan.path}"] = 2
    return want


def serve_phase(reference) -> dict:
    """Phase 3: serve on the card through both kernel paths, unfused and
    fused; hold the results against the port on the CPU
    (``cpu_reference()``). Returns each kernel's launch count from its
    path's serving run."""
    from repro_torch.core import bcnn, bconv
    from repro_torch.core import execution_plan as xp
    from repro_torch.serve.bcnn_engine import BCNNEngine

    counters = bcnn_counters()
    x_np, packed_cpu, hs, logits_cpu = reference
    x_cpu = hs[0]
    packed_b = bcnn.fold_model(bcnn.params_from_numpy(
        bcnn.numpy_params(SEED + 1)))
    logits_cpu_b = bcnn.forward_packed(packed_b, x_cpu, path="xla").numpy()

    launches = {}
    timings = {}
    for fusion in (False, True):
        for path in ("mxu", "vpu"):
            tag = f"{path}{' fused' if fusion else ''}"
            eng = BCNNEngine.from_packed(packed_cpu, n_slots=N_SLOTS,
                                         path=path, conv_fusion=fusion,
                                         device="cuda")
            eng.warmup()
            for fn in counters.values():
                fn.launches = 0
            steps, served = serve(eng, x_np, logits_cpu, tag)
            seen = {name: fn.launches for name, fn in counters.items()}
            print(f"[{tag}] launches over {steps} forwards: {seen}")
            want = {k: n * steps
                    for k, n in forward_launches(eng.plan).items()}
            check(all(seen[k] == v for k, v in want.items()),
                  f"[{tag}] expected {want} launches")
            check(all(v == 0 for k, v in seen.items() if k not in want),
                  f"[{tag}] a kernel of another path launched")
            for k in want:
                if k not in launches or "pair" in k:
                    launches[k] = seen[k]
            graph_checks(eng, tag, x_np, served, packed_cpu, packed_b,
                         logits_cpu_b)

            packed_gpu = eng.forward.packed
            if fusion:
                for pair in ((2, 3), (4, 5)):
                    got = bcnn.apply_packed_group(
                        packed_gpu, pair, hs[pair[0]].cuda(),
                        plan=eng.plan).cpu()
                    check(torch.equal(got, hs[pair[1] + 1]),
                          f"[{tag}] fused group {pair} differs from the "
                          f"CPU port")
                print(f"[{tag}] fused groups (2, 3) and (4, 5) fed the CPU "
                      f"input at tiles {list(eng.plan.group_tiles)}: bits "
                      f"exact")
            else:
                for strategy in ("direct", "im2col"):
                    plan = xp.build_plan(packed_gpu, path=path,
                                         conv_strategy=strategy,
                                         device="cuda")
                    for idx in range(1, bcnn.N_LAYERS):
                        got = bcnn.apply_packed_layer(
                            packed_gpu, idx, hs[idx].cuda(), plan=plan).cpu()
                        want_h = hs[idx + 1]
                        if idx == bcnn.N_LAYERS - 1:
                            check(torch.allclose(got, want_h, rtol=1e-5,
                                                 atol=1e-5),
                                  f"[{tag}/{strategy}] FC-3 logits differ")
                        else:
                            check(torch.equal(got, want_h),
                                  f"[{tag}/{strategy}] layer {idx} output "
                                  f"differs from the CPU port")
                    print(f"[{tag}/{strategy}] layers 1..8 each fed the CPU "
                          f"input: bits exact, FC-3 logits allclose")
                layer_ms = [time_ms(lambda i=i, h=hs[i][:N_SLOTS].cuda():
                                    bcnn.apply_packed_layer(
                                        packed_gpu, i, h, plan=eng.plan),
                                    reps=20)
                            for i in range(bcnn.N_LAYERS)]
                print(f"[{tag}] per-layer ms per call at batch {N_SLOTS} "
                      f"(CONV-1..FC-3, CUDA events): "
                      + ", ".join(f"{t:.4f}" for t in layer_ms))
            fwd = eng.forward
            xb = x_cpu[:N_SLOTS].cuda()
            print(f"[{tag}] profile of the eager forward at batch "
                  f"{N_SLOTS}:")
            eager = profile_forward(
                lambda x: bcnn.forward_packed(fwd.packed, x, plan=fwd.plan),
                xb)
            print(f"[{tag}] profile of the served forward (one CUDA-graph "
                  f"replay on the engine's stream) at batch {N_SLOTS}:")
            timings[tag] = (eager, profile_forward(fwd, xb,
                                                   stream=fwd.stream))
            eng.close()

    z_cpu = bconv.fpconv_apply(packed_cpu.conv1, x_cpu, binarize_out=False)
    z_gpu = bconv.fpconv_apply(packed_gpu.conv1, x_cpu.cuda(),
                               binarize_out=False).cpu()
    diff = (z_cpu >= 0) != (z_gpu >= 0)
    n_diff = int(diff.sum())
    check(bool((z_cpu[diff].abs() < 1e-3).all()),
          "a CONV-1 bit differs where |z| >= 1e-3")
    print(f"CONV-1 bits differing between card and CPU: {n_diff} of "
          f"{diff.numel()} (all at |z| < 1e-3); max |z_gpu - z_cpu| "
          f"{(z_gpu - z_cpu).abs().max().item():.3g}")
    print(f"eager vs replayed forward at batch {N_SLOTS} "
          f"({smi('name,power.limit')}): wall ms, device ms, idle share, "
          f"profiler launches")
    for tag, (e, r) in timings.items():
        print(f"  [{tag}] wall {e['wall_ms']:.4f} -> {r['wall_ms']:.4f}, "
              f"device {e['device_ms']:.4f} -> {r['device_ms']:.4f}, idle "
              f"{e['idle']:.3f} -> {r['idle']:.3f}, launches "
              f"{e['launches']} -> {r['launches']}")
    print(f"card: {smi('name,power.limit')}")
    return launches


def tune_phase(reference):
    """Phase 4: tune the plan on the card twice and require the two plans
    to agree and every candidate to be bit-exact; export the plan in an
    artifact, reload it as the cached plan and serve with it against the
    CPU port (``cpu_reference()``). Returns the reloaded plan."""
    import tempfile

    from repro_torch.core import bcnn_artifact
    from repro_torch.core import execution_plan as xp
    from repro_torch.kernels import autotune as at
    from repro_torch.serve.bcnn_engine import BCNNEngine

    def ms(score):
        return "-" if score is None else (f"{score[0] * 1e3:.4f} ± "
                                          f"{score[1] * 1e3:.4f}")

    x_np, packed_cpu, _, logits_cpu = reference
    plans = []
    for run in (1, 2):
        report = {}
        t0 = time.perf_counter()
        plan = at.autotune_packed(packed_cpu, device="cuda", batch=N_SLOTS,
                                  report=report)
        dt = time.perf_counter() - t0
        totals = {p: ms(t) for p, t in report["path_totals"].items()}
        print(f"[tune {run}] {report['n_candidates']} candidates, "
              f"{report['n_eligible']} eligible, in {dt:.1f} s; path "
              f"totals (device ms, sum of per-layer medians ± spreads at "
              f"batch {N_SLOTS}): {totals}")
        print(f"[tune {run}] fusion {'on' if plan.conv_fusion else 'off'} "
              f"(fused pairs {ms(report['fused_s'])} ms vs sequential "
              f"{ms(report['sequential_s'])} ms); plan "
              f"{json.dumps(xp.plan_to_dict(plan))}")
        check(report["n_eligible"] == report["n_candidates"],
              "a tuner candidate was not bit-exact with the CPU path")
        check(report["key"]["backend"] == "cuda", "tuner key not cuda")
        plans.append(plan)
    for row in report["candidates"]:
        print(f"  {row['candidate']}: "
              f"{ms((row['median_s'], row['spread_s']))} ms")
    check(plans[0] == plans[1], f"two tunings chose different plans: "
          f"{plans[0]} vs {plans[1]}")
    print("[tune] the two tunings chose the same plan")
    with tempfile.TemporaryDirectory() as tmp:
        bcnn_artifact.save_packed(
            tmp, packed_cpu, tuning=at.tuning_section(packed_cpu, plan),
            provenance={"exported_by": "chip_smoke"})
        loaded = bcnn_artifact.load_packed(tmp)
        cached, source = at.plan_for_host(
            loaded, bcnn_artifact.load_tuning(tmp), "cuda")
    check(source == "cached" and cached == plan,
          f"exported plan reloaded as {source!r}, not the cached plan")
    print(f"[tune] artifact reloaded: plan source {source!r}, key "
          f"{xp.plan_key_fingerprint(report['key'])} {report['key']}")
    eng = BCNNEngine.from_packed(loaded, n_slots=N_SLOTS, plan=cached,
                                 device="cuda")
    eng.warmup()
    serve(eng, x_np, logits_cpu, "tuned")
    return cached


def fleet_drive(router, x_np, rate_hz, mix, refs, tag, swap_to=None):
    """Drive ``router`` (threaded, warmed) with mixed Poisson traffic
    (``drive_mixed_poisson``), the launch counters zeroed just before and
    read just after. Require zero drops, a closed ledger per class, one
    capture on every replica, the path's launches on every step, and each
    result equal to its stamped epoch's references ``refs[epoch] = (card
    eager logits, CPU port logits)``: bitwise to the first, allclose 1e-5
    with equal argmax to the second. Returns the drive's numbers."""
    from repro_torch.serve import drive_mixed_poisson
    counters = bcnn_counters()
    plan = router.replicas[0].engine.plan
    steps0 = sum(r.engine.steps_executed for r in router.replicas_ever)
    for fn in counters.values():
        fn.launches = 0
    d = drive_mixed_poisson(router, x_np, rate_hz, mix=mix, seed=SEED,
                            swap_to=swap_to)
    seen = {k: fn.launches for k, fn in counters.items()}
    steps = sum(r.engine.steps_executed
                for r in router.replicas_ever) - steps0
    n = len(x_np)
    check(d["n_accepted"] == n and d["n_rejected"] == 0
          and len(d["results"]) == n and router.pending == 0,
          f"[{tag}] dropped requests: {d['n_accepted']} of {n} accepted, "
          f"{len(d['results'])} served")
    for name, c in router.counters().items():
        check(c["submitted"] == c["completed"] and c["shed"] == 0,
              f"[{tag}] ledger of {name} not closed: {c}")
    want = {k: v * steps for k, v in forward_launches(plan).items()}
    check(all(seen[k] == want.get(k, 0) for k in seen),
          f"[{tag}] launches {seen} over {steps} steps, expected {want}")
    for i, q in enumerate(d["requests"]):
        card, cpu = refs[q.epoch]
        check(np.array_equal(q.logits, card[i]),
              f"[{tag}] request {i} (epoch {q.epoch}, replica "
              f"{q.replica_id}) differs from the eager card forward")
        check(np.allclose(q.logits, cpu[i], rtol=1e-5, atol=1e-5)
              and q.logits.argmax() == cpu[i].argmax(),
              f"[{tag}] request {i} differs from the CPU port")
    caches = [r.step_cache_size for r in router.replicas_ever]
    check(all(c == 1 for c in caches), f"[{tag}] step_cache_size {caches}")
    if swap_to is not None:
        check(set(d["epochs"]) == {0, 1}
              and all(r.epoch == 1 for r in router.replicas),
              f"[{tag}] the rolling swap did not span the drive: "
              f"{d['epochs']}")
    span = (max(q.t_done for q in d["requests"])
            - min(q.t_submit for q in d["requests"]))
    out = {"img_s": n / span, "steps": steps, "epochs": d["epochs"]}
    parts = []
    for name, st in d["stats"].items():
        out[name] = (st["p50"] * 1e3, st["p99"] * 1e3)
        parts.append(f"{name} n={st['n']} p50 {st['p50'] * 1e3:.3f} ms "
                     f"p99 {st['p99'] * 1e3:.3f} ms")
    print(f"[{tag}] {n} requests offered at {rate_hz:g} req/s: "
          + "; ".join(parts) + f"; {out['img_s']:.1f} img/s over "
          f"{steps} steps ({n / steps:.2f} images a step); epochs served "
          f"{dict(sorted(d['epochs'].items()))}; launches {want}; every "
          f"result bitwise equal to its epoch's eager card forward; "
          f"step_cache_size {caches}")
    return out


def fleet_phase(reference, plan) -> None:
    """Phase 5: the replica fleet on the card (``serve/router.py``): the
    tuned ``plan`` shared by every replica, each replica's step one
    CUDA-graph replay on its own stream and thread. Mixed online + bulk
    Poisson traffic at ``PRIORITY_MIX`` through 2 replicas with a rolling
    swap mid-drive, then 1 and 2 replicas at the same rate and saturated
    (``fleet_drive`` checks each); then an autoscaled fleet through 1 ->
    2 -> 1 replicas under a bulk burst, replica 1 captured on the
    controller thread while replica 0 serves. Every wait is bounded."""
    from repro_torch.configs import bcnn_cifar10 as pc
    from repro_torch.core import bcnn
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.launch.serve_bcnn import parse_priority_mix
    from repro_torch.serve import AutoscaleConfig, Router

    _, packed_a, _, _ = reference
    packed_b = bcnn.fold_model(bcnn.params_from_numpy(
        bcnn.numpy_params(SEED + 1)))
    x_np, _ = SyntheticImages(global_batch=FLEET_REQUESTS,
                              seed=SEED + 2).batch(0)
    refs = {}
    for epoch, packed in enumerate((packed_a, packed_b)):
        fwd = bcnn.make_packed_forward(packed, plan=plan, device="cuda")
        refs[epoch] = (eager_logits(fwd, x_np), bcnn.forward_packed(
            packed, torch.from_numpy(x_np), path="xla").numpy())
        fwd.close()
    mix = parse_priority_mix(pc.PRIORITY_MIX)

    def fleet(n_replicas, **kw):
        return Router.from_packed(
            packed_a, n_replicas=n_replicas, n_slots=N_SLOTS, plan=plan,
            device="cuda", threaded=True, max_queue=kw.pop(
                "max_queue", FLEET_REQUESTS),
            online_reserve=pc.ONLINE_RESERVE, bulk_chunk=pc.BULK_CHUNK,
            **kw)

    print(f"[fleet] plan {plan.path}, fusion "
          f"{'on' if plan.conv_fusion else 'off'}; {N_SLOTS} slots a "
          f"replica, mix {pc.PRIORITY_MIX}, online deadline "
          f"{pc.ONLINE_DEADLINE_S} s; {smi('name,power.limit')}")
    rows = {}
    for n_rep, rate, swap in ((2, FLEET_RATE_HZ, True),
                              (1, FLEET_RATE_HZ, False),
                              (2, FLEET_SATURATE_HZ, False),
                              (1, FLEET_SATURATE_HZ, False)):
        tag = (f"fleet {n_rep}x{N_SLOTS} @ {rate:g}"
               + (" + rolling swap" if swap else ""))
        router = fleet(n_rep)
        try:
            rows[tag] = fleet_drive(router, x_np, rate, mix, refs, tag,
                                    swap_to=packed_b if swap else None)
        finally:
            router.shutdown(timeout=FLEET_TIMEOUT_S)

    cfg = AutoscaleConfig(
        min_replicas=1, max_replicas=2,
        up_watermark=pc.AUTOSCALE_UP_WATERMARK,
        down_watermark=pc.AUTOSCALE_DOWN_WATERMARK,
        window_s=pc.AUTOSCALE_WINDOW_S, cooldown_s=pc.AUTOSCALE_COOLDOWN_S,
        interval_s=pc.AUTOSCALE_INTERVAL_S)
    router = fleet(1, autoscale=cfg, max_queue=FLEET_BURST)
    try:
        rep0 = router.replicas[0]
        during = []
        scale_up = router.scale_up

        def timed_scale_up():
            steps0, t0 = rep0.engine.steps_executed, time.perf_counter()
            rep = scale_up()
            during.append((rep0.engine.steps_executed - steps0,
                           time.perf_counter() - t0))
            return rep
        router.scale_up = timed_scale_up
        reps = FLEET_BURST // FLEET_REQUESTS
        t0 = time.perf_counter()
        reqs = router.submit_batch(np.concatenate([x_np] * reps), cls="bulk")
        for r in reqs:
            r.wait(timeout=FLEET_TIMEOUT_S)
        dt = time.perf_counter() - t0
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while router.autoscaler.n_scale_downs < 1:
            check(time.monotonic() < deadline, "[autoscale] no scale-down")
            time.sleep(0.01)
        timeline = [n for _, n in router.autoscaler.timeline(1)]
        check(timeline == [1, 2, 1], f"[autoscale] timeline {timeline}")
        check(len(during) == 1 and during[0][0] > 0,
              f"[autoscale] replica 0 took no step while replica 1 was "
              f"built and captured: {during}")
        card = np.concatenate([refs[0][0]] * reps)
        got = np.concatenate([r.logits if r.logits.ndim == 2
                              else r.logits[None] for r in reqs])
        check(np.array_equal(got, card),
              "[autoscale] results differ from the eager card forward")
        ever = router.replicas_ever
        caches = [r.step_cache_size for r in ever]
        check(len(ever) == 2 and all(c == 1 for c in caches)
              and all(r.served > 0 for r in ever),
              f"[autoscale] replicas {[(r.id, r.served) for r in ever]}, "
              f"step_cache_size {caches}")
        c = router.counters()["bulk"]
        check(c["submitted"] == c["completed"] == FLEET_BURST
              and c["shed"] == 0, f"[autoscale] ledger {c}")
        print(f"[autoscale] bulk burst of {FLEET_BURST} images in chunks of "
              f"{pc.BULK_CHUNK}: served in {dt * 1e3:.1f} ms "
              f"({FLEET_BURST / dt:.1f} img/s); replicas 1 -> 2 -> 1; "
              f"replica 1 built and captured in {during[0][1] * 1e3:.1f} ms "
              f"while replica 0 took {during[0][0]} steps; served "
              f"{[(r.id, r.served) for r in ever]}; step_cache_size "
              f"{caches}; every result bitwise equal to the eager card "
              f"forward")
    finally:
        router.shutdown(timeout=FLEET_TIMEOUT_S)
    print(f"card: {smi('name,power.limit')}")


def plan_launches(path: str, groups) -> dict:
    """Kernel launches of one micro-batch through ``groups`` (one
    ``plan_layer_groups`` tuple per stage) on ``path``: a fused pair
    launches K5, any other binary conv K3/K4 (direct), an FC K1/K2;
    CONV-1 is plain PyTorch."""
    want: dict = {}
    for stage in groups:
        for g in stage:
            if len(g) == 2:
                k = f"xnor_conv2d_pair_{path}"
            elif 1 <= g[0] <= 5:
                k = f"xnor_conv2d_{path}"
            elif g[0] >= 6:
                k = f"xnor_matmul_{path}"
            else:
                continue
            want[k] = want.get(k, 0) + 1
    return want


def multi_forwards(packed, plan, dev):
    """(name, forward, per-stage groups, rows of one launch unit) of
    every stage-pipelined and data-parallel form of phase 5b, built one
    at a time (the caller closes each before the next, so the pooled
    streams stay few). Several shards or stages share ``dev``."""
    from repro_torch.parallel.bcnn_data_parallel import make_sharded_forward
    from repro_torch.parallel.bcnn_pipeline import make_pipelined_forward
    for n_stages in (1, 2, 3):
        for mb in MULTI_PIPE_MB:
            fwd = make_pipelined_forward(packed, n_stages=n_stages,
                                         micro_batch=mb, devices=[dev],
                                         plan=plan)
            yield (f"pipeline {n_stages} stage(s), micro-batch {mb}", fwd,
                   fwd.fused_groups(), mb, mb)
    for shards, n_stages in MULTI_GRIDS:
        for mb in MULTI_DATA_MB:
            fwd = make_sharded_forward(packed, data_shards=shards,
                                       n_stages=n_stages, micro_batch=mb,
                                       devices=[dev] * shards, plan=plan)
            yield (f"data {shards} shard(s) x {n_stages} stage(s), "
                   f"micro-batch {mb}", fwd, fwd.plan.fused_groups,
                   fwd.plan.chunk, mb)


def multi_checks(packed_a, packed_b, x, plan, dev, repeats: int) -> dict:
    """Every form of ``multi_forwards`` on route ``plan`` against the
    route's ``PackedForward`` on ``dev``: bitwise equal at every N of
    ``MULTI_N``, ``repeats`` calls each queued back to back before any
    is read, one graph a stage or shard (``cache_size`` 1), the launches
    of one call at N = 64 (counters zeroed just before and read just
    after) equal to the plan's, then swapped to ``packed_b`` and bitwise
    equal to its ``PackedForward`` again with no new capture. Returns the
    launches seen by kernel name."""
    from repro_torch.core import bcnn
    counters = bcnn_counters()
    route = f"{plan.path}{' fused' if plan.conv_fusion else ''}"
    refs = []
    for pk in (packed_a, packed_b):
        ref = bcnn.make_packed_forward(pk, plan=plan, device=dev)
        refs.append({n: ref(x[:n]) for n in MULTI_N})
        ref.close()
    check(not torch.equal(refs[0][257], refs[1][257]),
          f"[{route}] the two nets give the same logits")
    seen_all: dict = {}
    for name, fwd, groups, granule, mb in multi_forwards(packed_a, plan,
                                                        dev):
        tag = f"[multi {route}] {name}"
        for n in MULTI_N:
            outs = [fwd(x[:n]) for _ in range(repeats)]
            bad = [i for i, o in enumerate(outs)
                   if not torch.equal(o, refs[0][n])]
            check(not bad, f"{tag}: N={n}, calls {bad} differ from "
                           f"PackedForward")
        check(fwd.cache_size() == 1, f"{tag}: cache_size "
                                     f"{fwd.cache_size()}")
        for fn in counters.values():
            fn.launches = 0
        fwd(x[:64])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seen = {k: fn.launches for k, fn in counters.items() if fn.launches}
        units = -(-64 // granule) * granule // mb
        want = {k: v * units
                for k, v in plan_launches(plan.path, groups).items()}
        check(seen == want, f"{tag}: launches {seen}, expected {want}")
        for k, v in seen.items():
            seen_all[k] = seen_all.get(k, 0) + v
        fwd.swap(packed_b)
        for n in (7, 257):
            outs = [fwd(x[:n]) for _ in range(3)]
            check(all(torch.equal(o, refs[1][n]) for o in outs),
                  f"{tag}: after the swap, N={n} differs from the new "
                  f"net's PackedForward")
        check(fwd.cache_size() == 1, f"{tag}: the swap captured anew")
        times = ""
        if hasattr(fwd, "stage_times"):
            times = ", stage ms " + "/".join(
                f"{t * 1e3:.4f}" for t in fwd.stage_times(x, reps=20))
        fwd.close()
        print(f"{tag}: bitwise == PackedForward at N {list(MULTI_N)} x "
              f"{repeats} and after a swap; cache_size 1; one call at "
              f"N=64 launched {seen} ({units} micro-batch(es)){times}")
    return seen_all


def device_busy(fn, n: int = 2):
    """(ms per call of the union of device activity, ms per call of the
    sum of kernel and copy times, the top kernels as (ms per call, count
    per call, name)) from torch.profiler over ``n`` calls of ``fn``; the
    union counts work that overlaps on several streams once. None when
    the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return None
    union, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            union += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    union += hi - lo
    top = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            top.append((t / n / 1e3, ev.count / n, ev.key))
    return (union / n / 1e3, sum(e - s for s, e in spans) / n / 1e3,
            sorted(top, reverse=True)[:6])


def timed_row(fn, images: int, what: str, n: int = 3,
              kernels: bool = False) -> dict:
    """Host wall per call of ``fn`` (``n`` calls after one warm call,
    ending in a sync), images/s, the device's busy ms (``device_busy``,
    a separate profiled run: a device-bound call's idle share can come
    out a little below 0) and idle share 1 - busy / wall; printed as one
    row, with the top kernels when ``kernels``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    busy = device_busy(fn)
    row = {"wall_ms": wall, "img_s": images / wall * 1e3,
           "busy_ms": None if busy is None else busy[0],
           "idle": None if busy is None else 1 - busy[0] / wall}
    dev = ("device not measured (the profiler recorded no device "
           "activity)" if busy is None else
           f"device busy {busy[0]:.4f} ms (kernel + copy sum "
           f"{busy[1]:.4f}), idle share {row['idle']:.3f}")
    print(f"  {what}: {row['img_s']:.1f} img/s, wall {wall:.4f} ms, {dev}")
    if kernels and busy is not None:
        for ms, count, key in busy[2]:
            print(f"      {ms:.4f} ms  x{count:g}  {key[:90]}")
    return row


def multi_phase(reference, tuned) -> None:
    """Phase 5b: the multi-device forwards (``parallel/bcnn_pipeline.py``,
    ``parallel/bcnn_data_parallel.py``) and ``classify_batch``'s bulk
    route at full Table 2 width, every stage and shard side by side on
    the one card, each on its own stream. In all four routes
    (``multi_checks``): the pipeline at 1, 2 and 3 stages and the
    data-parallel forward at 1 and 2 shards and 2 x 2, bitwise equal to
    the route's ``PackedForward``, before and after a swap; then the
    engine's ``classify_batch`` through the bulk and slot routes (bitwise
    equal, one capture each, the bulk route's launches counted), and on
    the ``tuned`` plan both routes timed at ``MULTI_TIMED_N`` beside one
    graph at 4096 images in every route and the side-by-side forms on
    device input at 4096 images."""
    from repro_torch.configs import bcnn_cifar10 as pc
    from repro_torch.core import bcnn
    from repro_torch.core import execution_plan as xp
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.parallel.bcnn_data_parallel import make_sharded_forward
    from repro_torch.parallel.bcnn_pipeline import make_pipelined_forward
    from repro_torch.serve.bcnn_engine import BCNNEngine

    dev = torch.device("cuda")
    _, packed_a, _, _ = reference
    packed_b = bcnn.fold_model(bcnn.params_from_numpy(
        bcnn.numpy_params(SEED + 1)))
    x_np, _ = SyntheticImages(global_batch=max(MULTI_TIMED_N),
                              seed=SEED + 3).batch(0)
    x = torch.from_numpy(x_np).to(dev)
    card = smi("name,power.limit")
    t0 = time.perf_counter()
    for fusion in (False, True):
        for path in ("mxu", "vpu"):
            plan = xp.build_plan(packed_a, path=path, conv_fusion=fusion,
                                 device=dev)
            multi_checks(packed_a, packed_b, x, plan, dev, MULTI_REPEATS)
    print(f"[multi] four routes checked in {time.perf_counter() - t0:.1f} "
          f"s; {card}")

    counters = bcnn_counters()
    route = f"{tuned.path}{' fused' if tuned.conv_fusion else ''}"
    for stages in (1, 2):
        eng = BCNNEngine.from_packed(
            packed_a, n_slots=N_SLOTS, plan=tuned, device=dev,
            pipeline_stages=stages, data_shards=1,
            data_micro_batch=pc.DATA_MICRO_BATCH)
        tag = f"[engine {route}, {stages} stage(s)]"
        check(eng.batch_cache_size == 0, f"{tag} bulk forward ran early")
        ref = bcnn.make_packed_forward(packed_a, plan=tuned, device=dev)
        want = {n: ref(x[:n]).cpu().numpy() for n in MULTI_N}
        ref.close()
        eng.classify_batch(x_np[:pc.DATA_MICRO_BATCH])  # capture first
        for fn in counters.values():
            fn.launches = 0
        bulk = eng.classify_batch(x_np[:257])
        seen = {k: fn.launches for k, fn in counters.items() if fn.launches}
        units = -(-257 // eng.batch_threshold)
        expect = {k: v * units for k, v in plan_launches(
            tuned.path, eng.batch_forward.plan.fused_groups).items()}
        check(seen == expect and eng.steps_executed == 0,
              f"{tag} bulk route launched {seen}, expected {expect}")
        slots = eng.classify_batch(x_np[:7])
        check(np.array_equal(bulk, want[257])
              and np.array_equal(slots, want[7]),
              f"{tag} classify_batch differs from PackedForward")
        check(eng.batch_cache_size == 1 and eng.step_cache_size == 1
              and eng.steps_executed == 2,
              f"{tag} batch_cache_size {eng.batch_cache_size}, "
              f"step_cache_size {eng.step_cache_size}, steps "
              f"{eng.steps_executed}")
        eng.close()
        print(f"{tag} classify_batch: 257 images by the bulk route "
              f"({units} chunks, launches {seen}) and 7 by the slots (2 "
              f"steps), bitwise == PackedForward; batch_cache_size 1, "
              f"step_cache_size 1")

    print(f"[multi timing] plan {route}; host wall per call (images in "
          f"host memory for the engines, on the card for the forwards), "
          f"device busy = union of kernel and copy intervals "
          f"(torch.profiler); {card}")
    engines = {"slot route, 4 slots": dict(),
               f"bulk route, 1 shard x {pc.DATA_MICRO_BATCH}": dict(
                   data_shards=1, data_micro_batch=pc.DATA_MICRO_BATCH,
                   batch_threshold=1),
               "bulk route, 1 shard x 256": dict(
                   data_shards=1, data_micro_batch=256, batch_threshold=1)}
    for what, kw in engines.items():
        eng = BCNNEngine.from_packed(packed_a, n_slots=N_SLOTS, plan=tuned,
                                     device=dev, **kw)
        for n in MULTI_TIMED_N:
            timed_row(lambda n=n: eng.classify_batch(x_np[:n]), n,
                      f"{what}, N={n}")
        eng.close()
    n = max(MULTI_TIMED_N)
    for fusion in (False, True):            # the plan at the bulk batch
        for path in ("mxu", "vpu"):
            plan = xp.build_plan(packed_a, path=path, conv_fusion=fusion,
                                 device=dev)
            fwd = bcnn.make_packed_forward(packed_a, plan=plan, device=dev)
            timed_row(lambda: fwd(x[:n]), n,
                      f"PackedForward {path}{' fused' if fusion else ''}, "
                      f"one graph at N={n}", kernels=True)
            fwd.close()
    forms = {
        "PackedForward, one graph at N": lambda: bcnn.make_packed_forward(
            packed_a, plan=tuned, device=dev),
        "data 2 shards x 128 (side by side)": lambda: make_sharded_forward(
            packed_a, data_shards=2, micro_batch=128, devices=[dev] * 2,
            plan=tuned),
        "data 1 shard x 2 stages x 256": lambda: make_sharded_forward(
            packed_a, data_shards=1, n_stages=2, micro_batch=256,
            devices=[dev], plan=tuned),
        "pipeline 2 stages x 256": lambda: make_pipelined_forward(
            packed_a, n_stages=2, micro_batch=256, devices=[dev],
            plan=tuned),
        "pipeline 3 stages x 256": lambda: make_pipelined_forward(
            packed_a, n_stages=3, micro_batch=256, devices=[dev],
            plan=tuned),
    }
    for what, make in forms.items():
        fwd = make()
        timed_row(lambda: fwd(x[:n]), n, f"{what}, N={n}",
                  kernels="pipeline" in what)
        if hasattr(fwd, "stage_times"):
            print(f"    stage_times (ms, micro-batch 256): " + ", ".join(
                f"{t * 1e3:.4f}" for t in fwd.stage_times(x, reps=20)))
        fwd.close()
    print(f"card: {card}")


def lm_serve(cfg, packed, prompts, device, mode, path, swap_to=None):
    """Serve ``prompts`` through a 4-slot engine on ``device``; with
    ``swap_to``, hot-swap that packed net after ``LM_SWAP_AT`` steps and
    require every weight tensor to keep its storage. Returns (tokens per
    prompt, wall seconds, engine)."""
    from repro_torch.models import xnor_lm as xl
    eng, model = xl.make_serving_engine(cfg, packed, n_slots=N_SLOTS,
                                        mode=mode, path=path, device=device)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=LM_MAX_NEW) for p in prompts]
    if swap_to is None:
        out = eng.run()
    else:
        out = eng.run(max_steps=LM_SWAP_AT)
        ptrs = [t.data_ptr() for t in eng.params]
        eng.swap_params(model.swap_arrays(swap_to))
        check([t.data_ptr() for t in eng.params] == ptrs,
              "a weight tensor changed storage in the hot-swap")
        out.update(eng.run())
    dt = time.perf_counter() - t0
    check(sorted(out) == sorted(rids), f"[lm {device} {mode}] requests lost")
    toks = [out[r] for r in rids]
    check(all(len(t) == LM_MAX_NEW and all(0 <= x < cfg.vocab_size
                                           for x in t) for t in toks),
          f"[lm {device} {mode}] malformed tokens")
    return toks, dt, eng


def lm_phase() -> int:
    """Phase 6: the XNOR LM at full CONFIG on the card against the same
    port on the CPU. Returns K6's launch count from the "bw" serving
    run."""
    from repro_torch import configs
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import xnor_matmul as kmm
    from repro_torch.models import xnor_lm as xl
    from repro_torch.serve.slots import latency_stats

    cfg = configs.get_config("xnor-lm-tiny")
    packed = xl.fold(cfg, xl.params_from_numpy(xl.numpy_params(cfg, SEED)))
    packed2 = xl.fold(cfg, xl.params_from_numpy(
        xl.numpy_params(cfg, SEED + 1)))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (LM_PROMPT,)).tolist()
               for _ in range(LM_REQUESTS)]
    print(f"[lm] CONFIG {cfg}: {LM_REQUESTS} requests (prompt {LM_PROMPT}, "
          f"max_new {LM_MAX_NEW}) through {N_SLOTS} slots")

    # probe forward at (2, 8): "bw" and "xnor" bitwise equal on the card,
    # allclose to the CPU port (float32 spine in another order)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    gpu = xl.packed_to(packed, "cuda")
    want = xl.forward_packed(cfg, packed, toks, mode="bw")
    logits = {(m, p): xl.forward_packed(cfg, gpu, toks.cuda(), mode=m,
                                        path=p).cpu()
              for m, p in (("bw", "mxu"), ("xnor", "vpu"), ("xnor", "mxu"))}
    for key, got in logits.items():
        check(torch.equal(got, logits[("bw", "mxu")]),
              f"[lm] forward_packed {key} differs from bw on the card")
    got = logits[("bw", "mxu")]
    check(got.shape == (2, 8, cfg.vocab_size) and bool(got.isfinite().all())
          and torch.allclose(got, want, rtol=1e-5, atol=1e-5)
          and torch.equal(got.argmax(-1), want.argmax(-1)),
          f"[lm] forward_packed on the card vs CPU: max "
          f"{(got - want).abs().max():.3g}")
    print(f"[lm] forward_packed (2, 8): bw == xnor/vpu == xnor/mxu bitwise "
          f"on the card; max |gpu - cpu| {(got - want).abs().max():.3g}, "
          f"argmax equal")

    want_toks, _, _ = lm_serve(cfg, packed, prompts, "cpu", "bw", "xla")
    counters = {"binary_weight_matmul": kmm.binary_weight_matmul,
                "xnor_matmul_vpu": kmm.xnor_matmul_vpu,
                "xnor_matmul_mxu": kmm.xnor_matmul_mxu}
    per_step = 6 * cfg.n_layers                # K6 or K1/K2 calls per step
    k6_launches = None
    for mode, path, kernel in (("bw", "mxu", "binary_weight_matmul"),
                               ("xnor", "vpu", "xnor_matmul_vpu"),
                               ("xnor", "mxu", "xnor_matmul_mxu")):
        tag = f"lm {mode}{'/' + path if mode == 'xnor' else ''}"
        for fn in counters.values():
            fn.launches = 0
        toks_gpu, dt, eng = lm_serve(cfg, packed, prompts, "cuda", mode, path)
        seen = {k: fn.launches for k, fn in counters.items()}
        steps = eng.steps_executed
        print(f"[{tag}] launches over {steps} decode steps: {seen}")
        check(seen[kernel] == per_step * steps and all(
            v == 0 for k, v in seen.items() if k != kernel),
            f"[{tag}] expected {per_step} {kernel} launches per step and "
            f"no other binary matmul")
        if mode == "bw":
            k6_launches = seen[kernel]
        check(toks_gpu == want_toks, f"[{tag}] served tokens differ from "
              f"the CPU port's")
        st = latency_stats(eng.sched.finished)
        n_tok = sum(len(t) for t in toks_gpu)
        print(f"[{tag}] tokens equal the CPU port's; indicative only "
              f"({LM_REQUESTS} requests): {n_tok / dt:.1f} tok/s, request "
              f"latency p50 {st['p50'] * 1e3:.2f} ms, p99 "
              f"{st['p99'] * 1e3:.2f} ms, {dt * 1e3 / steps:.3f} ms per "
              f"step")

    want_swap, _, _ = lm_serve(cfg, packed, prompts, "cpu", "bw", "xla",
                               swap_to=packed2)
    got_swap, _, _ = lm_serve(cfg, packed, prompts, "cuda", "bw", "mxu",
                              swap_to=packed2)
    check(got_swap == want_swap, "[lm swap] tokens differ from the CPU port")
    check(got_swap != want_toks, "[lm swap] the swap changed no token")
    print(f"[lm swap] hot-swap after {LM_SWAP_AT} steps: every weight kept "
          f"its storage, tokens equal the CPU port's under the same swap")

    modes = []
    for run in (1, 2):
        report = {}
        t0 = time.perf_counter()
        modes.append(at.autotune_lm_mode(cfg, packed, device="cuda",
                                         n_slots=N_SLOTS, report=report))
        check(report["equal"], "[lm tune] bw and xnor logits differ")
        print(f"[lm tune {run}] {modes[-1]} in "
              f"{time.perf_counter() - t0:.1f} s; decode step at "
              f"{N_SLOTS} slots, device ms "
              f"(median ± spread): " + ", ".join(
                  f"{m} {t * 1e3:.4f} ± {sp * 1e3:.4f}"
                  for m, (t, sp) in report["scores"].items())
              + f" (xnor on {report['path']})")
    check(modes[0] == modes[1], f"[lm tune] two races disagree: {modes}")

    # one decode step at 4 slots, mode bw: launches, wall, device, idle
    eng, model = xl.make_serving_engine(cfg, packed, n_slots=N_SLOTS,
                                        device="cuda")
    state = model.init_state(N_SLOTS, cfg.max_len)
    step_toks = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device="cuda")

    def step():
        return model.decode_step(eng.params, state, step_toks)[0]

    step()
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    busy_ms = device_ms(step, n=9, per_gate=1)
    print(f"[lm] decode step (bw, {N_SLOTS} slots): wall {wall_ms:.4f} ms, "
          f"device {busy_ms:.4f} ms, device idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    rows = kernel_rows(step, 10)
    if rows:
        print(f"  per-kernel breakdown (torch.profiler): "
              f"{sum(r[1] for r in rows)} launches, "
              f"{sum(r[0] for r in rows):.4f} ms of kernels per step")
        for t, count, key in rows[:10]:
            print(f"    {t:.4f} ms  x{count}  {key[:90]}")
    else:
        print("  per-kernel breakdown: not measured (the profiler recorded "
              "no device kernels)")
    print(f"card: {smi('name,power.limit')}")
    return k6_launches


def dense_tree_bytes(params) -> int:
    from repro_torch.train.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def profile_call(fn, n: int, what: str):
    """Host wall ms per call of ``fn`` (``n`` calls ending in a sync), the
    profiler's device kernel ms per call, launches per call, and the
    profiler's rows (``kernel_rows``); prints them with the device's idle
    share (1 - kernel time / wall) and the top kernels. A call of the dense LM launches over a thousand kernels, more
    than ``device_ms``'s sleep gate can queue, so its device time is the
    profiler's sum of kernel times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    rows = kernel_rows(fn, n)
    if not rows:
        print(f"  {what}: wall {wall_ms:.4f} ms; device time not measured "
              f"(the profiler recorded no device kernels)")
        return wall_ms, float("nan"), 0, rows
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"  {what}: {launches} launches, wall {wall_ms:.4f} ms, device "
          f"(kernel sum) {busy:.4f} ms, device idle share "
          f"{1 - busy / wall_ms:.3f}; top kernels (torch.profiler):")
    for ms, count, key in rows[:10]:
        print(f"    {ms:.4f} ms  x{count}  {key[:90]}")
    return wall_ms, busy, launches, rows


def argmax_agrees(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(positions where the argmax differs although the reference's top-1
    leads its runner-up by more than 2·tol, positions within that margin).
    Inside the margin the two orders of summation may pick either."""
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    differ = got.argmax(-1) != want.argmax(-1)
    return int((differ & clear).sum()), int((~clear).sum())


def zero_k7() -> None:
    from repro_torch.kernels import flash_attention as kfa
    kfa.flash_attention.launches = 0
    kfa.flash_attention.launches_tc = 0
    kfa.flash_attention.launches_simt = 0


def plain_attention_k7_order(q, k, v, *, causal=True):
    """``ref.flash_attention_ref`` with K7 tc's order of rounding: the
    unnormalised p (float32) is rounded to v's dtype, multiplied by V with
    float32 sums, and only then divided by l, in float32, before the cast
    to q's dtype (the plain version rounds p / l)."""
    s, hd = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kr = torch.repeat_interleave(k, g, dim=1)
    vr = torch.repeat_interleave(v, g, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        sc = torch.where(mask[None, None], sc, -1e30)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr.float())
    return (pv / l).to(q.dtype)


def bf16_cut(full, rng, dev) -> None:
    """Two layers of ``full`` at full width, bf16, ``prefill`` at
    ``DENSE_PREFILL``: every K7 call on the views ``gqa_forward`` hands
    over ("tc") is held against the plain version on the same views, and
    the logits against the same cut with plain attention (relative L2 at
    most the bf16 ``FLASH_TOL`` rtol). The cut also runs with the plain
    attention in K7's order of rounding (``plain_attention_k7_order``):
    both relative L2 gaps are printed, to tell the model's sensitivity to
    where p is rounded (the second gap closes) from a fault of K7 (it
    does not)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf

    cut = full.with_(n_layers=2)
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    toks = torch.from_numpy(rng.integers(0, cut.vocab_size,
                                         DENSE_PREFILL)).to(dev)
    k7 = ops.flash_attention
    held_calls = []

    def held(q, k, v, *, causal=True):
        what = f"[dense bf16 cut] layer {len(held_calls)} K7"
        check(not q.is_contiguous() and all(
            kfa.tma_ready(t) for t in (q, k, v)),
            f"{what}: gqa_forward did not hand over tma_ready views")
        n_tc = kfa.flash_attention.launches_tc
        out = k7(q, k, v, causal=causal)
        check(kfa.flash_attention.launches_tc == n_tc + 1,
              f"{what}: not a tc launch")
        held_calls.append(flash_check(
            out, ref.flash_attention_ref(q, k, v, causal=causal),
            torch.bfloat16, what))
        return out

    def plain(q, k, v, *, causal=True):
        return ref.flash_attention_ref(q, k, v, causal=causal)

    cut_logits = {}
    for attn, fn in (("K7 tc", held), ("plain", plain),
                     ("plain, K7 order", plain_attention_k7_order)):
        ops.flash_attention = fn
        try:
            cut_logits[attn] = tf.prefill(cut, params, toks).float()
        finally:
            ops.flash_attention = k7
    got, want = cut_logits["K7 tc"], cut_logits["plain"]
    rel = float((got - want).norm() / want.norm())
    k7_order = cut_logits["plain, K7 order"]
    rel_order = float((got - k7_order).norm() / k7_order.norm())
    rel_plains = float((k7_order - want).norm() / want.norm())
    check(len(held_calls) == cut.n_layers, f"[dense bf16 cut] "
          f"{len(held_calls)} K7 calls, expected {cut.n_layers}")
    check(bool(got.isfinite().all())
          and rel <= FLASH_TOL[torch.bfloat16]["rtol"],
          f"[dense bf16 cut] logits through K7 vs plain attention: relative "
          f"L2 difference {rel:.3g}")
    print(f"[dense bf16 cut] 2 layers, prefill {DENSE_PREFILL}: each K7 tc "
          f"call on the views gqa_forward hands over == plain version on "
          f"them (max |err| {max(e for e, _ in held_calls):.3g}, at most "
          f"{max(sh for _, sh in held_calls):.5f} beyond one ulp); logits "
          f"vs plain attention: relative L2 {rel:.3g} (limit "
          f"{FLASH_TOL[torch.bfloat16]['rtol']}), max |diff| "
          f"{float((got - want).abs().max()):.3g}, argmax "
          f"{'equal' if int(got.argmax()) == int(want.argmax()) else 'differs'}")
    print(f"[dense bf16 cut] logits relative L2: K7 tc vs plain {rel:.4g}; "
          f"K7 tc vs plain in K7's rounding order {rel_order:.4g}; the two "
          f"plains apart {rel_plains:.4g}; argmax vs the K7-order plain "
          f"{'equal' if int(got.argmax()) == int(k7_order.argmax()) else 'differs'}")
    check(bool(k7_order.isfinite().all()), "[dense bf16 cut] the K7-order "
          "plain logits are not finite")


def dense_phase() -> tuple[int, int, float]:
    """Phase 7: the dense LM zoo at Qwen3-8B's full width. Returns K7's
    launch counts (simt, tc): "simt" from the float32 two-layer cut's
    ``prefill``, "tc" from the full-depth bf16 prefill (the main path's
    run), and that prefill's kernel ms (the profiler's sum)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.slots import latency_stats

    full = configs.get_config(DENSE_ARCH)
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    # --- (a) two layers at full width, float32: card vs the CPU port
    cfg = full.with_(n_layers=2, dtype="float32")
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    params_cpu = tf.tree_map(lambda x: x.cpu(), params)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, DENSE_CPU_TOKENS))
    print(f"[dense] {DENSE_ARCH} cut to 2 layers, float32, "
          f"{dense_tree_bytes(params) / 1e9:.3f} GB of weights; tokens "
          f"{DENSE_CPU_TOKENS}")
    for what in ("prefill", "forward_train"):
        def on(p, x, what=what):
            if what == "prefill":
                return tf.prefill(cfg, p, x)
            return tf.forward_train(cfg, p, tf.Batch(x, x))[0]
        zero_k7()
        got = on(params, toks.to(dev))
        torch.cuda.synchronize()
        n_k7 = kfa.flash_attention.launches
        check(n_k7 == cfg.n_layers == kfa.flash_attention.launches_simt,
              f"[dense {what}] {n_k7} K7 launches "
              f"({kfa.flash_attention.launches_simt} simt), expected "
              f"{cfg.n_layers} simt")
        if what == "prefill":
            simt_launches = n_k7
        got = got.cpu()
        want = on(params_cpu, toks)
        err = float((got - want).abs().max())
        check(got.shape == want.shape and bool(got.isfinite().all())
              and torch.allclose(got, want, **DENSE_TOL),
              f"[dense {what}] card vs CPU: max |diff| {err:.3g}")
        bad, near = argmax_agrees(got, want, DENSE_TOL["atol"])
        check(bad == 0, f"[dense {what}] argmax differs at {bad} positions "
              f"with a clear top-1")
        print(f"[dense {what}] card == CPU port: logits {tuple(got.shape)} "
              f"max |diff| {err:.3g} (rtol = atol = {DENSE_TOL['atol']}), "
              f"argmax equal ({near} positions within the tie margin), "
              f"{n_k7} K7 launches, all simt")
    del params_cpu

    # --- (b) prefill (K7) vs feeding the prompt through decode_step
    prompt = toks[:1, :DENSE_DECODE_PROMPT].to(dev)
    want = tf.prefill(cfg, params, prompt)[0, -1]
    state = tf.init_serve_state(cfg, 1, DENSE_DECODE_PROMPT, dev)
    for i in range(DENSE_DECODE_PROMPT):
        logits, state = tf.decode_step(cfg, params, state, prompt[:, i:i + 1])
    got = logits[0, -1]
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **DENSE_TOL)
          and int(got.argmax()) == int(want.argmax()),
          f"[dense] prefill vs decode_step on the card: max |diff| {err:.3g}")
    print(f"[dense] prefill == {DENSE_DECODE_PROMPT} decode steps on the "
          f"card: last logits max |diff| {err:.3g}, argmax equal")
    del params, state, logits
    torch.cuda.empty_cache()

    # --- (c) two layers at full width, bf16, through K7 tc and plain
    bf16_cut(full, rng, dev)
    torch.cuda.empty_cache()

    # --- (d) full depth and width, bf16: prefill at (1, 4096)
    t0 = time.perf_counter()
    params = tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tf.tree_leaves(params))
    # ModelConfig.param_count leaves out the norm scales
    n_norm = full.n_layers * (2 * full.d_model + 2 * full.head_dim
                              * full.qk_norm) + full.d_model
    print(f"[dense] full {DENSE_ARCH}: {full.n_layers} layers, {n_par:,} "
          f"parameters ({full.param_count():,} counted by the config + "
          f"{n_norm:,} norm scales), {dense_tree_bytes(params) / 1e9:.3f} GB,"
          f" made on the card in {time.perf_counter() - t0:.1f} s")
    check(n_par == full.param_count() + n_norm,
          "parameter count differs from the config's")
    toks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                         DENSE_PREFILL)).to(dev)

    def prefill():
        return tf.prefill(full, params, toks)

    prefill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_k7()
    logits = prefill()
    torch.cuda.synchronize()
    k7_launches = kfa.flash_attention.launches
    check(k7_launches == full.n_layers == kfa.flash_attention.launches_tc,
          f"[dense prefill] {k7_launches} K7 launches "
          f"({kfa.flash_attention.launches_tc} tc), expected "
          f"{full.n_layers} tc")
    check(logits.shape == (1, 1, full.vocab_size)
          and bool(logits.isfinite().all()), "[dense prefill] logits "
          "malformed or not finite")
    print(f"[dense prefill] {DENSE_PREFILL}: logits finite, {k7_launches} K7 "
          f"launches, all tc, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; CUDA events {time_ms(prefill, reps=3, warmup=0):.2f} ms per "
          f"prefill")
    prefill_kernel_ms = profile_call(prefill, 2,
                                     f"prefill {DENSE_PREFILL}")[1]
    del logits

    # --- (e) served through the default TransformerServeModel
    prompts = [rng.integers(0, full.vocab_size, (LM_PROMPT,)).tolist()
               for _ in range(LM_REQUESTS)]
    eng = ServingEngine(full, params, n_slots=N_SLOTS, max_len=DENSE_MAX_LEN,
                        device=dev)
    model = eng.model
    del params                         # the engine holds its own copy
    torch.cuda.empty_cache()
    zero_k7()
    t0 = time.perf_counter()
    rids = [eng.submit(pr, max_new_tokens=LM_MAX_NEW) for pr in prompts]
    out = eng.run()
    dt = time.perf_counter() - t0
    check(sorted(out) == sorted(rids) and all(
        len(out[r]) == LM_MAX_NEW for r in rids), "[dense serve] requests "
        "lost or short")
    check(kfa.flash_attention.launches == 0, "[dense serve] the decode path "
          "launched K7")
    toks0 = out[rids[0]]
    # the same prompt alone in slot 0, the other slots idle, stepped by hand
    state = model.init_state(N_SLOTS, DENSE_MAX_LEN)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    alone: list[int] = []
    for i in range(LM_PROMPT + LM_MAX_NEW - 1):
        feed[0, 0] = prompts[0][i] if i < LM_PROMPT else alone[-1]
        logits, state = model.decode_step(eng.params, state, feed)
        if i >= LM_PROMPT - 1:
            alone.append(int(torch.argmax(logits[0, -1])))
    check(alone == toks0, f"[dense serve] request 0's tokens {toks0} differ "
          f"from a hand-rolled decode loop {alone}")
    st = latency_stats(eng.sched.finished)
    n_tok = sum(len(v) for v in out.values())
    steps = eng.steps_executed
    print(f"[dense serve] {LM_REQUESTS} requests (prompt {LM_PROMPT}, "
          f"{LM_MAX_NEW} new) through {N_SLOTS} slots in {steps} steps; "
          f"request 0 equals a hand-rolled decode loop; indicative only: "
          f"{n_tok / dt:.1f} tok/s, p50 {st['p50'] * 1e3:.1f} ms, p99 "
          f"{st['p99'] * 1e3:.1f} ms, {dt * 1e3 / steps:.2f} ms per step")
    state = model.init_state(N_SLOTS, DENSE_MAX_LEN)
    feed.zero_()
    profile_call(lambda: model.decode_step(eng.params, state, feed), 3,
                 f"decode step at {N_SLOTS} slots")
    del state, logits

    # hot-swap a second seed's weights mid-run, in place
    rids = [eng.submit(pr, max_new_tokens=LM_MAX_NEW) for pr in prompts]
    out2 = eng.run(max_steps=LM_SWAP_AT)
    ptrs = [x.data_ptr() for x in eng.params]
    new = model.swap_arrays(tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED + 1), dev))
    eng.swap_params(new)
    del new
    torch.cuda.empty_cache()
    check([x.data_ptr() for x in eng.params] == ptrs,
          "[dense swap] a weight tensor changed storage")
    out2.update(eng.run())
    check(sorted(out2) == sorted(rids) and all(
        len(out2[r]) == LM_MAX_NEW for r in rids), "[dense swap] requests "
        "lost or short")
    changed = sum(out2[r] != out[r0] for r, r0 in zip(rids, sorted(out)))
    check(changed > 0, "[dense swap] the swap changed no token")
    print(f"[dense swap] hot-swap after {LM_SWAP_AT} steps: all "
          f"{len(ptrs)} weight tensors kept their storage; {changed} of "
          f"{LM_REQUESTS} requests' tokens changed")
    print(f"card: {smi('name,power.limit')}")
    return simt_launches, k7_launches, prefill_kernel_ms


class RouteLog:
    """Records, on the host, (expert_idx, probs) of every
    ``models/moe.py::route`` call made inside the ``with`` block."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._route = [], moe.route

        def recorded(p, cfg, x):
            out = self._route(p, cfg, x)
            self.calls.append((out[2].cpu(), out[0].cpu()))
            return out
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def route_keep(got: RouteLog, want: RouteLog, k: int, margin: float,
               what: str):
    """(B, S) mask of the positions before the first routing difference of
    their sequence in any MoE layer, and the relative gaps (p_k - p_k+1) /
    p_k, of ``want``'s router, at the positions whose top-k expert sets
    differ; each must lie below ``margin``."""
    check(len(got.calls) == len(want.calls) > 0,
          f"{what}: {len(got.calls)} vs {len(want.calls)} router calls")
    keep, gaps = None, []
    for (gi, _), (wi, wp) in zip(got.calls, want.calls):
        differ = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
        top = wp.topk(k + 1, dim=-1).values
        gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
        here_gaps = gap[differ].tolist()
        gaps += here_gaps
        check(all(g < margin for g in here_gaps),
              f"{what}: a token's experts differ at a relative router gap "
              f"{max(here_gaps, default=0):.3g} >= {margin}")
        s = differ.shape[-1]
        first = torch.where(differ.any(-1), differ.int().argmax(-1),
                            torch.full_like(differ[:, 0], s, dtype=torch.int64))
        here = torch.arange(s)[None, :] < first[:, None]
        keep = here if keep is None else keep & here
    return keep, gaps


def logits_agree(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor,
                 tol: dict, what: str) -> str:
    """Hold ``got`` against ``want`` (both (B, S, V) on the host) at the
    ``keep`` positions: allclose at ``tol``, argmax equal where the top-1
    is clear (``argmax_agrees``). Returns a summary."""
    check(got.shape == want.shape and bool(got.isfinite().all()),
          f"{what}: logits {tuple(got.shape)} malformed or not finite")
    g, w = got.float()[keep], want.float()[keep]
    check(g.shape[0] > 0, f"{what}: no position left to compare")
    err = float((g - w).abs().max())
    check(torch.allclose(g, w, **tol), f"{what}: max |diff| {err:.3g}")
    bad, near = argmax_agrees(g, w, tol["atol"])
    check(bad == 0, f"{what}: argmax differs at {bad} positions with a "
          f"clear top-1")
    return (f"max |diff| {err:.3g} over {g.shape[0]} of {keep.numel()} "
            f"positions (rtol {tol['rtol']}, atol {tol['atol']}), argmax "
            f"equal ({near} within the tie margin)")


def moe_norm_scales(cfg) -> int:
    """Norm scales of a moe tree, which ModelConfig.param_count leaves
    out: ln1, ln2, the kv-norm and (with q-LoRA) the q-norm a layer, and
    the final norm."""
    return cfg.n_layers * (2 * cfg.d_model + cfg.kv_lora_rank
                           + cfg.q_lora_rank) + cfg.d_model


def moe_cut_checks(full, rng, dev) -> None:
    """(a)-(c): the 2-layer float32 cut of ``full`` (layer 0 MLA with the
    dense FFN, layer 1 MLA with the MoE), card vs the CPU port at
    ``DENSE_TOL`` under the routing rule, at quant "none" and
    "binary_weights"; then prefill vs an 8-token prompt fed through
    ``decode_step`` on the card."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf

    cut = full.with_(n_layers=2, dtype="float32")
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    params_cpu = tf.tree_map(lambda x: x.cpu(), params)
    toks = torch.from_numpy(rng.integers(0, cut.vocab_size, DENSE_CPU_TOKENS))
    print(f"[moe] {MOE_ARCH} cut to 2 layers, float32, "
          f"{dense_tree_bytes(params) / 1e9:.3f} GB of weights; tokens "
          f"{DENSE_CPU_TOKENS}")
    for quant in ("none", "binary_weights"):
        cfg = cut.with_(quant=quant)
        for what in ("prefill", "forward_train"):
            tag = f"[moe {quant} {what}]"

            def on(p, x, what=what):
                if what == "prefill":
                    return tf.prefill(cfg, p, x), None
                return tf.forward_train(cfg, p, tf.Batch(x, x))

            zero_k7()
            with RouteLog() as card_routes:
                got, aux = on(params, toks.to(dev))
                torch.cuda.synchronize()
            n_k7 = kfa.flash_attention.launches
            check(n_k7 == cfg.n_layers == kfa.flash_attention.launches_simt,
                  f"{tag} {n_k7} K7 launches "
                  f"({kfa.flash_attention.launches_simt} simt), expected "
                  f"{cfg.n_layers} simt")
            with RouteLog() as cpu_routes:
                want, want_aux = on(params_cpu, toks)
            keep, gaps = route_keep(card_routes, cpu_routes, cfg.top_k,
                                    MOE_ROUTE_MARGIN, tag)
            if what == "prefill":
                keep = keep[:, -1:]
            msg = logits_agree(got.cpu(), want, keep, DENSE_TOL, tag)
            if aux is not None:
                aux, want_aux = float(aux), float(want_aux)
                check(abs(aux - want_aux) <= DENSE_TOL["atol"]
                      + DENSE_TOL["rtol"] * abs(want_aux),
                      f"{tag} aux {aux} vs CPU {want_aux}")
                msg += f"; aux {aux:.6g} vs CPU {want_aux:.6g}"
            print(f"{tag} card == CPU port: {msg}; {len(gaps)} routing "
                  f"near-ties left out (relative gaps "
                  f"{[f'{g:.3g}' for g in gaps]}, margin {MOE_ROUTE_MARGIN})"
                  f"; {n_k7} K7 launches, all simt")
    del params_cpu

    # (c) prefill (K7) vs the absorbed decode, an 8-token prompt
    prompt = toks[:1, :MOE_DECODE_PROMPT].to(dev)
    want = tf.prefill(cut, params, prompt)[0, -1]
    state = tf.init_serve_state(cut, 1, MOE_DECODE_PROMPT, dev)
    for i in range(MOE_DECODE_PROMPT):
        logits, state = tf.decode_step(cut, params, state, prompt[:, i:i + 1])
    got = logits[0, -1]
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **DENSE_TOL)
          and int(got.argmax()) == int(want.argmax()),
          f"[moe] prefill vs decode_step on the card: max |diff| {err:.3g}")
    print(f"[moe] prefill == {MOE_DECODE_PROMPT} absorbed decode steps on "
          f"the card (quant none): last logits max |diff| {err:.3g}, argmax "
          f"equal")


def moe_big_cut(rng, dev) -> int:
    """(f): deepseek-v2-236b cut to 2 layers at full width (128 heads,
    q-LoRA 1536, 160 experts), bf16, ``prefill`` at ``MOE_BIG_PREFILL``
    through K7 tc against the same cut with plain attention on the card.
    The last position is compared where its experts, and whether each
    took it within capacity, are the same in both runs. Returns the K7
    launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cut = configs.get_config(MOE_BIG_ARCH).with_(n_layers=2)
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_par = sum(x.numel() for x in tf.tree_leaves(params))
    toks = torch.from_numpy(rng.integers(0, cut.vocab_size,
                                         MOE_BIG_PREFILL)).to(dev)
    zero_k7()
    with RouteLog() as k7_routes:
        got = tf.prefill(cut, params, toks)
        torch.cuda.synchronize()
    n_k7 = kfa.flash_attention.launches
    check(n_k7 == cut.n_layers == kfa.flash_attention.launches_tc,
          f"[moe 236b cut] {n_k7} K7 launches, expected {cut.n_layers} tc")
    k7 = ops.flash_attention
    ops.flash_attention = ref.flash_attention_ref
    try:
        with RouteLog() as plain_routes:
            want = tf.prefill(cut, params, toks)
    finally:
        ops.flash_attention = k7
    _, gaps = route_keep(k7_routes, plain_routes, cut.top_k,
                         MOE_BF16_ROUTE_MARGIN, "[moe 236b cut]")
    (gi, _), = k7_routes.calls
    (wi, _), = plain_routes.calls
    cap = moe.capacity(MOE_BIG_PREFILL[1], cut.n_experts, cut.top_k)

    def last_token(idx):
        """The last token's experts, and those that took it in capacity."""
        _, se, st, ok, _ = moe.dispatch(idx, cap)
        mine = st[0] == idx.shape[1] - 1
        return sorted(se[0][mine].tolist()), sorted(se[0][mine & ok[0]].tolist())
    same = last_token(gi) == last_token(wi)
    keep = torch.tensor([[same]])
    check(bool(got.isfinite().all()), "[moe 236b cut] logits not finite")
    msg = (logits_agree(got.cpu(), want.cpu(), keep, MOE_BF16_TOL,
                        "[moe 236b cut] K7 vs plain attention")
           if same else "last position left out (its experts or drops "
           "differ between the runs)")
    print(f"[moe 236b cut] {MOE_BIG_ARCH} cut to 2 layers at full width "
          f"({cut.n_heads} heads, q-LoRA {cut.q_lora_rank}, "
          f"{cut.n_experts} experts), "
          f"bf16, {n_par:,} parameters, {dense_tree_bytes(params) / 1e9:.3f} "
          f"GB; prefill {MOE_BIG_PREFILL} through K7 tc ({n_k7} launches) "
          f"vs plain attention on the card: {msg}; {len(gaps)} of "
          f"{gi.shape[1]} tokens routed differently, all near-ties "
          f"(relative gaps below {MOE_BF16_ROUTE_MARGIN}, largest "
          f"{max(gaps, default=0):.3g})")
    t_ms = time_ms(lambda: tf.prefill(cut, params, toks), reps=3)
    profile_call(lambda: tf.prefill(cut, params, toks), 2,
                 f"236b 2-layer prefill {MOE_BIG_PREFILL} (CUDA events "
                 f"{t_ms:.2f} ms)")
    return n_k7


def moe_phase(dev: torch.device) -> int:
    """Phase 7b: the moe family at full width on ``dev``. Returns the K7
    launches (all "tc") of the full-depth Lite prefill (the main path's
    run) and the 236b cut."""
    import gc

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.slots import latency_stats

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] device memory held on entry: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    full = configs.get_config(MOE_ARCH)
    rng = np.random.default_rng(SEED)

    moe_cut_checks(full, rng, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # --- (d) all 27 layers at full width, bf16: prefill at (1, 4096)
    t0 = time.perf_counter()
    params = tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tf.tree_leaves(params))
    n_norm = moe_norm_scales(full)
    print(f"[moe] full {MOE_ARCH}: {full.n_layers} layers ({full.n_experts} "
          f"routed + {full.n_shared_experts} shared experts, top-"
          f"{full.top_k}), {n_par:,} parameters ({full.param_count():,} "
          f"counted by the config + {n_norm:,} norm scales), "
          f"{dense_tree_bytes(params) / 1e9:.3f} GB, made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_par == full.param_count() + n_norm,
          "[moe] parameter count differs from the config's")
    toks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                         DENSE_PREFILL)).to(dev)

    def prefill():
        return tf.prefill(full, params, toks)

    prefill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_k7()
    logits = prefill()
    torch.cuda.synchronize()
    k7_launches = kfa.flash_attention.launches
    check(k7_launches == full.n_layers == kfa.flash_attention.launches_tc
          and kfa.flash_attention.launches_simt == 0,
          f"[moe prefill] {k7_launches} K7 launches "
          f"({kfa.flash_attention.launches_tc} tc, "
          f"{kfa.flash_attention.launches_simt} simt), expected "
          f"{full.n_layers} tc and 0 simt")
    check(logits.shape == (1, 1, full.vocab_size)
          and bool(logits.isfinite().all()), "[moe prefill] logits "
          "malformed or not finite")
    print(f"[moe prefill] {DENSE_PREFILL}: logits finite, {k7_launches} K7 "
          f"launches, all tc (q/k at "
          f"{full.qk_nope_head_dim + full.qk_rope_head_dim}, v at "
          f"{full.v_head_dim}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"CUDA events {time_ms(prefill, reps=3, warmup=0):.2f} ms per "
          f"prefill")
    _, busy, _, rows = profile_call(prefill, 2, f"prefill {DENSE_PREFILL}")
    k7_ms = sum(r[0] for r in rows if "flash_attention_tc" in r[2])
    print(f"  K7 tc: {k7_ms:.4f} ms of {busy:.4f} ms of kernels per "
          f"prefill ({k7_ms / busy:.3f} of the kernel time)")
    del logits

    # --- (e) served through the default TransformerServeModel
    prompts = [rng.integers(0, full.vocab_size, (LM_PROMPT,)).tolist()
               for _ in range(LM_REQUESTS)]
    eng = ServingEngine(full, params, n_slots=N_SLOTS, max_len=DENSE_MAX_LEN,
                        device=dev)
    model = eng.model
    del params                         # the engine holds its own copy
    gc.collect()
    torch.cuda.empty_cache()
    zero_k7()
    t0 = time.perf_counter()
    rids = [eng.submit(pr, max_new_tokens=LM_MAX_NEW) for pr in prompts]
    out = eng.run()
    dt = time.perf_counter() - t0
    check(sorted(out) == sorted(rids) and all(
        len(out[r]) == LM_MAX_NEW for r in rids), "[moe serve] requests "
        "lost or short")
    check(kfa.flash_attention.launches == 0, "[moe serve] the decode path "
          "launched K7")
    toks0 = out[rids[0]]
    state = model.init_state(N_SLOTS, DENSE_MAX_LEN)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    alone: list[int] = []
    for i in range(LM_PROMPT + LM_MAX_NEW - 1):
        feed[0, 0] = prompts[0][i] if i < LM_PROMPT else alone[-1]
        logits, state = model.decode_step(eng.params, state, feed)
        if i >= LM_PROMPT - 1:
            alone.append(int(torch.argmax(logits[0, -1])))
    check(alone == toks0, f"[moe serve] request 0's tokens {toks0} differ "
          f"from a hand-rolled decode loop {alone}")
    st = latency_stats(eng.sched.finished)
    n_tok = sum(len(v) for v in out.values())
    steps = eng.steps_executed
    print(f"[moe serve] {LM_REQUESTS} requests (prompt {LM_PROMPT}, "
          f"{LM_MAX_NEW} new) through {N_SLOTS} slots in {steps} steps, 0 K7 "
          f"launches; request 0 equals a hand-rolled decode loop; "
          f"{n_tok / dt:.1f} tok/s, p50 {st['p50'] * 1e3:.1f} ms, p99 "
          f"{st['p99'] * 1e3:.1f} ms, {dt * 1e3 / steps:.2f} ms per step")
    state = model.init_state(N_SLOTS, DENSE_MAX_LEN)
    feed.zero_()
    zero_k7()
    profile_call(lambda: model.decode_step(eng.params, state, feed), 3,
                 f"decode step at {N_SLOTS} slots")
    check(kfa.flash_attention.launches == 0, "[moe serve] the profiled "
          "decode step launched K7")
    del state, logits

    # hot-swap a second seed's weights mid-run, in place
    rids = [eng.submit(pr, max_new_tokens=LM_MAX_NEW) for pr in prompts]
    out2 = eng.run(max_steps=LM_SWAP_AT)
    ptrs = [x.data_ptr() for x in eng.params]
    new = model.swap_arrays(tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED + 1), dev))
    print(f"[moe swap] peak device memory with the second tree: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    eng.swap_params(new)
    del new
    gc.collect()
    torch.cuda.empty_cache()
    check([x.data_ptr() for x in eng.params] == ptrs,
          "[moe swap] a weight tensor changed storage")
    out2.update(eng.run())
    check(sorted(out2) == sorted(rids) and all(
        len(out2[r]) == LM_MAX_NEW for r in rids), "[moe swap] requests "
        "lost or short")
    changed = sum(out2[r] != out[r0] for r, r0 in zip(rids, sorted(out)))
    check(changed > 0, "[moe swap] the swap changed no token")
    print(f"[moe swap] hot-swap after {LM_SWAP_AT} steps: all {len(ptrs)} "
          f"weight tensors kept their storage (data_ptr); {changed} of "
          f"{LM_REQUESTS} requests' tokens changed")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()

    # --- (f) deepseek-v2-236b, 2 layers at full width
    big_launches = moe_big_cut(rng, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"card: {smi('name,power.limit')}")
    return k7_launches + big_launches


def recurrent_extra_params(cfg) -> int:
    """Parameters of a vlm, ssm or hybrid tree that
    ``ModelConfig.param_count`` leaves out: the norms (and ``ln_x``'s
    bias), the vision projection, rwkv6's shift mixes, decay bias, decay
    LoRA and bonus, and Mamba-2's conv, its per-head vectors (A, D, Δ
    bias) and inner norm."""
    from repro_torch.models import mamba2, rwkv6
    d, n_layers = cfg.d_model, cfg.n_layers
    if cfg.family == "vlm":
        return n_layers * 2 * d + d + d * d
    if cfg.family == "ssm":
        time_mix = 5 * d + d + 2 * rwkv6.DECAY_LORA * d + d + 2 * d
        return n_layers * (time_mix + 2 * d + 2 * d) + d
    d_inner, nh, n = mamba2._dims(cfg)
    mamba = mamba2.CONV_K * (d_inner + 2 * n) + 3 * nh + d_inner + d
    return n_layers * mamba + 2 * d + d


def watch_resets(model) -> list:
    """Wrap ``model.reset_slot`` so that every reset is followed by a
    check that the slot reads zero in every tensor of the state
    (``serve/engine.py::slot_part``). Returns the list of slots reset so
    far."""
    from repro_torch.serve.engine import slot_part, state_tensors
    seen: list[int] = []
    reset = model.reset_slot

    def checked(state, i, n_slots):
        state = reset(state, i, n_slots)
        for t in state_tensors(state.caches):
            part = slot_part(t, i, n_slots)
            check(part is not None and not bool(part.any()),
                  f"[serve] slot {i} of a {tuple(t.shape)} state tensor is "
                  f"not zero after reset")
        seen.append(i)
        return state
    model.reset_slot = checked
    return seen


def recurrent_cut(full, rng, dev) -> int:
    """(a) ``full`` cut in depth (``RECURRENT_CUT_LAYERS``) at full width,
    float32: the card against the CPU port at ``DENSE_TOL``. The vlm:
    ``prefill`` and ``forward_train`` with a (1, 576, d) frontend and 64
    text tokens; the recurrent families: ``prefill`` at each
    ``RECURRENT_CUT_S``. K7's counters are zeroed just before each
    forward on the card and read just after. (b) For the recurrent
    families, ``prefill`` against a ``RECURRENT_DECODE_PROMPT``-token
    prompt fed through ``decode_step`` on the card. Returns the K7
    launches of (a)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf

    cut = full.with_(n_layers=RECURRENT_CUT_LAYERS[full.name],
                     dtype="float32")
    every = {"vlm": 1, "hybrid": cut.attn_every}.get(cut.family)
    n_attn = cut.n_layers // every if every else 0
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    params_cpu = tf.tree_map(lambda x: x.cpu(), params)
    tag = f"[{cut.name} cut]"
    print(f"{tag} {cut.n_layers} layers at full width ({cut.family}), "
          f"float32, {dense_tree_bytes(params) / 1e9:.3f} GB of weights; "
          f"{n_attn} attention layers or shared-block applications")
    v = cut.vocab_size
    if cut.family == "vlm":
        toks = torch.from_numpy(rng.integers(0, v, (1, RECURRENT_VLM_TEXT)))
        fe = torch.from_numpy(rng.standard_normal(
            (1, cut.frontend_seq, cut.d_model)).astype(np.float32))
        cases = [("prefill", toks, fe), ("forward_train", toks, fe)]
    else:
        cases = [("prefill", torch.from_numpy(rng.integers(0, v, (1, s))),
                  None) for s in RECURRENT_CUT_S]
    launches = 0
    for what, toks, fe in cases:
        def on(p, x, f, what=what):
            if what == "prefill":
                return tf.prefill(cut, p, x, frontend=f)
            return tf.forward_train(cut, p, tf.Batch(x, x, f))[0]
        zero_k7()
        got = on(params, toks.to(dev), None if fe is None else fe.to(dev))
        torch.cuda.synchronize()
        n_k7 = kfa.flash_attention.launches
        check(n_k7 == n_attn == kfa.flash_attention.launches_simt,
              f"{tag} {what}: {n_k7} K7 launches "
              f"({kfa.flash_attention.launches_simt} simt), expected "
              f"{n_attn} simt")
        launches += n_k7
        want = on(params_cpu, toks, fe)
        got = got.cpu()
        msg = logits_agree(got, want, torch.ones(got.shape[:2], dtype=bool),
                           DENSE_TOL, f"{tag} {what}")
        seq = toks.shape[1] + (0 if fe is None else fe.shape[1])
        print(f"{tag} {what} at S = {seq}: card == CPU port: {msg}; "
              f"{n_k7} K7 launches, all simt")
    del params_cpu
    if cut.family in ("ssm", "hybrid"):
        prompt = torch.from_numpy(rng.integers(
            0, v, (1, RECURRENT_DECODE_PROMPT))).to(dev)
        want = tf.prefill(cut, params, prompt)[0, -1]
        state = tf.init_serve_state(cut, 1, RECURRENT_DECODE_PROMPT, dev)
        for i in range(RECURRENT_DECODE_PROMPT):
            logits, state = tf.decode_step(cut, params, state,
                                           prompt[:, i:i + 1])
        got = logits[0, -1]
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **DENSE_TOL)
              and int(got.argmax()) == int(want.argmax()),
              f"{tag} prefill vs decode_step on the card: max |diff| "
              f"{err:.3g}")
        print(f"{tag} prefill (chunked forms) == {RECURRENT_DECODE_PROMPT} "
              f"decode steps (token scans) on the card: last logits max "
              f"|diff| {err:.3g} (rtol = atol = {DENSE_TOL['atol']}), "
              f"argmax equal")
    return launches


def recurrent_full(full, rng, dev) -> tuple[int, list]:
    """(c) ``full`` whole in bf16: ``prefill`` at S = 4096 (the vlm: 576
    patches + 3520 text tokens), ``RECURRENT_K7`` simt launches required,
    timed (CUDA events), its peak memory read and profiled with K7's
    share; (d) served through ``ServingEngine`` at 4 slots: every request
    done, no K7 launch in decode, request 0 equal to a hand-rolled decode
    loop, every reset slot zero in every state tensor at admission, a
    decode step profiled, and a second seed's weights hot-swapped mid-run
    with every weight keeping its storage. Returns (K7 launches of the
    prefill, rows for the summary table)."""
    import gc

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.slots import latency_stats

    name = full.name
    t0 = time.perf_counter()
    params = tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tf.tree_leaves(params))
    extra = recurrent_extra_params(full)
    print(f"[{name}] full: {full.n_layers} layers, d {full.d_model}, "
          f"{n_par:,} parameters ({full.param_count():,} counted by the "
          f"config + {extra:,} it leaves out), "
          f"{dense_tree_bytes(params) / 1e9:.3f} GB, made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_par == full.param_count() + extra,
          f"[{name}] parameter count differs from the config's")
    fe = None
    text = FLASH_PATH_S
    if full.family == "vlm":
        fe = torch.randn((1, full.frontend_seq, full.d_model),
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED), device=dev).to(torch.bfloat16)
        text -= full.frontend_seq
    toks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                         (1, text))).to(dev)

    def prefill():
        return tf.prefill(full, params, toks, frontend=fe)

    prefill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_k7()
    logits = prefill()
    torch.cuda.synchronize()
    n_k7 = kfa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(n_k7 == RECURRENT_K7[name] == kfa.flash_attention.launches_simt,
          f"[{name} prefill] {n_k7} K7 launches "
          f"({kfa.flash_attention.launches_simt} simt), expected "
          f"{RECURRENT_K7[name]} simt")
    check(logits.shape == (1, 1, full.vocab_size)
          and bool(logits.isfinite().all()),
          f"[{name} prefill] logits malformed or not finite")
    shape = (f"{full.frontend_seq} patches + {text} tokens" if fe is not None
             else f"(1, {text})")
    ev_ms = time_ms(prefill, reps=3, warmup=0)
    print(f"[{name} prefill] {shape}: logits finite, {n_k7} K7 launches, "
          f"all simt (hd {full.head_dim if n_k7 else '-'}), peak memory "
          f"{peak:.2f} GB; CUDA events {ev_ms:.2f} ms per prefill")
    wall, busy, n_launch, rows = profile_call(prefill, 2,
                                              f"prefill {shape}")
    k7_ms = sum(r[0] for r in rows if "flash_simt" in r[2])
    print(f"  K7 simt: {k7_ms:.4f} ms of {busy:.4f} ms of kernels per "
          f"prefill ({k7_ms / busy:.3f} of the kernel time)")
    table = [(f"{name} prefill {shape}", n_launch, wall, busy,
              1 - busy / wall, k7_ms / busy, peak)]
    del logits

    # (d) served through the default TransformerServeModel
    prompts = [rng.integers(0, full.vocab_size, (RECURRENT_PROMPT,)).tolist()
               for _ in range(RECURRENT_REQUESTS)]
    eng = ServingEngine(full, params, n_slots=N_SLOTS,
                        max_len=RECURRENT_MAX_LEN, device=dev)
    model = eng.model
    del params                         # the engine holds its own copy
    gc.collect()
    torch.cuda.empty_cache()
    resets = watch_resets(model)
    zero_k7()
    t0 = time.perf_counter()
    rids = [eng.submit(pr, max_new_tokens=RECURRENT_NEW) for pr in prompts]
    out = eng.run()
    dt = time.perf_counter() - t0
    check(sorted(out) == sorted(rids) and all(
        len(out[r]) == RECURRENT_NEW for r in rids),
        f"[{name} serve] requests lost or short")
    check(kfa.flash_attention.launches == 0,
          f"[{name} serve] the decode path launched K7")
    check(len(resets) == RECURRENT_REQUESTS,
          f"[{name} serve] {len(resets)} slot resets checked, expected "
          f"{RECURRENT_REQUESTS}")
    state = model.init_state(N_SLOTS, RECURRENT_MAX_LEN)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    alone: list[int] = []
    for i in range(RECURRENT_PROMPT + RECURRENT_NEW - 1):
        feed[0, 0] = prompts[0][i] if i < RECURRENT_PROMPT else alone[-1]
        logits, state = model.decode_step(eng.params, state, feed)
        if i >= RECURRENT_PROMPT - 1:
            alone.append(int(torch.argmax(logits[0, -1])))
    check(alone == out[rids[0]], f"[{name} serve] request 0's tokens "
          f"{out[rids[0]]} differ from a hand-rolled decode loop {alone}")
    st = latency_stats(eng.sched.finished)
    n_tok = sum(len(x) for x in out.values())
    steps = eng.steps_executed
    print(f"[{name} serve] {RECURRENT_REQUESTS} requests (prompt "
          f"{RECURRENT_PROMPT}, {RECURRENT_NEW} new) through {N_SLOTS} slots "
          f"in {steps} steps, 0 K7 launches, {len(resets)} slot resets each "
          f"read back zero in every state tensor; request 0 equals a "
          f"hand-rolled decode loop; {n_tok / dt:.1f} tok/s, p50 "
          f"{st['p50'] * 1e3:.1f} ms, p99 {st['p99'] * 1e3:.1f} ms, "
          f"{dt * 1e3 / steps:.2f} ms per step")
    state = model.init_state(N_SLOTS, RECURRENT_MAX_LEN)
    feed.zero_()
    zero_k7()
    wall, busy, n_launch, _ = profile_call(
        lambda: model.decode_step(eng.params, state, feed), 3,
        f"decode step at {N_SLOTS} slots")
    check(kfa.flash_attention.launches == 0,
          f"[{name} serve] the profiled decode step launched K7")
    table.append((f"{name} decode step, {N_SLOTS} slots", n_launch, wall,
                  busy, 1 - busy / wall, 0.0, float("nan")))
    del state, logits

    # hot-swap a second seed's weights mid-run, in place
    rids = [eng.submit(pr, max_new_tokens=RECURRENT_NEW) for pr in prompts]
    out2 = eng.run(max_steps=RECURRENT_SWAP_AT)
    ptrs = [x.data_ptr() for x in eng.params]
    new = model.swap_arrays(tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED + 1), dev))
    eng.swap_params(new)
    del new
    gc.collect()
    torch.cuda.empty_cache()
    check([x.data_ptr() for x in eng.params] == ptrs,
          f"[{name} swap] a weight tensor changed storage")
    out2.update(eng.run())
    check(sorted(out2) == sorted(rids) and all(
        len(out2[r]) == RECURRENT_NEW for r in rids),
        f"[{name} swap] requests lost or short")
    changed = sum(out2[r] != out[r0] for r, r0 in zip(rids, sorted(out)))
    check(changed > 0, f"[{name} swap] the swap changed no token")
    print(f"[{name} swap] hot-swap after {RECURRENT_SWAP_AT} steps: all "
          f"{len(ptrs)} weight tensors kept their storage (data_ptr); "
          f"{changed} of {RECURRENT_REQUESTS} requests' tokens changed; "
          f"{len(resets)} slot resets read back zero")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return n_k7, table


def recurrent_phase(dev: torch.device) -> int:
    """Phase 7c: the vlm, ssm and hybrid families at full width on
    ``dev`` (``recurrent_cut``, then ``recurrent_full``, for each of
    ``RECURRENT_ARCHS``). Returns the K7 launches of its main-path runs:
    the cuts' float32 forwards and the full bf16 prefills."""
    import gc

    from repro_torch import configs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[recurrent] device memory held on entry: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED)
    launches = 0
    for arch in RECURRENT_ARCHS:
        launches += recurrent_cut(configs.get_config(arch), rng, dev)
        gc.collect()
        torch.cuda.empty_cache()
    table = []
    for arch in RECURRENT_ARCHS:
        n, rows = recurrent_full(configs.get_config(arch), rng, dev)
        launches += n
        table += rows
        gc.collect()
        torch.cuda.empty_cache()
    print("[recurrent] call | launches | wall ms | kernel ms | idle | K7 "
          "share | peak GB")
    for what, n, wall, busy, idle, k7, peak in table:
        print(f"[recurrent] {what} | {n} | {wall:.4f} | {busy:.4f} | "
              f"{idle:.3f} | {k7:.3f} | {peak:.2f}")
    print(f"[recurrent] phase 7c wall {time.perf_counter() - t_phase:.1f} s;"
          f" card: {smi('name,power.limit')}")
    return launches


class K7Log:
    """Records (causal, variant launched) of every
    ``kernels/ops.py::flash_attention`` call made on the card inside the
    ``with`` block (the variant read from K7's launch counters)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ops
        self.calls, self._fn = [], ops.flash_attention

        def logged(q, k, v, *, causal=True):
            n_tc = kfa.flash_attention.launches_tc
            n_simt = kfa.flash_attention.launches_simt
            out = self._fn(q, k, v, causal=causal)
            ran = ("tc" if kfa.flash_attention.launches_tc > n_tc else
                   "simt" if kfa.flash_attention.launches_simt > n_simt
                   else "plain")
            self.calls.append((causal, ran))
            return out
        ops.flash_attention = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self._fn

    def count(self, causal: bool, variant: str) -> int:
        return sum(c == (causal, variant) for c in self.calls)


def audio_extra_params(cfg) -> int:
    """Parameters of the audio tree that ``ModelConfig.param_count``
    counts otherwise: the decoder's cross-attention (4 d² a layer, where
    the config counts d² a layer of the encoder), the frame projection
    (d²) and the LayerNorms' scales and biases (2 a block of the
    encoder, 3 of the decoder, the encoder's and the final norm)."""
    d = cfg.d_model
    return ((4 * cfg.n_layers - cfg.n_encoder_layers + 1) * d * d
            + (4 * cfg.n_encoder_layers + 6 * cfg.n_layers + 4) * d)


def audio_cut(full, rng, dev) -> int:
    """Phase 7d (a): ``full`` cut to ``AUDIO_CUT_LAYERS`` encoder and
    decoder layers at full width, float32: ``_encode``, ``prefill`` and
    ``forward_train`` at ``AUDIO_CUT_TOKENS`` on float32 frames, the card
    against the CPU port at ``DENSE_TOL``, each forward with K7's
    counters zeroed just before and read just after (2 non-causal and 2
    causal simt launches). (b) On the cut, ``prefill`` against an
    ``AUDIO_DECODE_PROMPT``-token prompt fed through ``decode_step`` on
    the card given the encoder K/V. (e, second half) The cut's packed
    form (``serve/packing.py``) built on the card and on the CPU: the
    same words and α bit for bit, and its prefill card vs CPU at
    ``DENSE_TOL``. Returns the K7 launches of (a) and (e)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as tf
    from repro_torch.serve import packing

    cut = full.with_(n_layers=AUDIO_CUT_LAYERS,
                     n_encoder_layers=AUDIO_CUT_LAYERS, dtype="float32")
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    params_cpu = tf.tree_map(lambda x: x.cpu(), params)
    tag = f"[{cut.name} cut]"
    print(f"{tag} {cut.n_encoder_layers} encoder + {cut.n_layers} decoder "
          f"layers at full width, float32, "
          f"{dense_tree_bytes(params) / 1e9:.3f} GB of weights; tokens "
          f"{AUDIO_CUT_TOKENS}, float32 frames ({AUDIO_CUT_TOKENS[0]}, "
          f"{cut.encoder_seq}, {cut.d_model})")
    b, s = AUDIO_CUT_TOKENS
    toks = torch.from_numpy(rng.integers(0, cut.vocab_size, (b, s)))
    fe = torch.from_numpy(rng.standard_normal(
        (b, cut.encoder_seq, cut.d_model)).astype(np.float32))
    n_attn = cut.n_layers + cut.n_encoder_layers
    launches = 0
    zero_k7()
    with K7Log() as log:
        got = tf._encode(cut, params, fe.to(dev))
    torch.cuda.synchronize()
    check(log.count(False, "simt") == cut.n_encoder_layers == len(log.calls),
          f"{tag} _encode: K7 calls {log.calls}, expected "
          f"{cut.n_encoder_layers} non-causal simt")
    launches += len(log.calls)
    want = tf._encode(cut, params_cpu, fe)
    for g, w, what in zip(got, want, "KV"):
        err = float((g.cpu() - w).abs().max())
        check(g.dtype == torch.float32 and torch.allclose(g.cpu(), w,
                                                          **DENSE_TOL),
              f"{tag} _encode {what}: max |diff| {err:.3g}")
        print(f"{tag} _encode {what} {tuple(g.shape)} float32: card == CPU "
              f"port, max |diff| {err:.3g}")
    del got, want
    for what in ("prefill", "forward_train"):
        def on(p, x, f, what=what):
            if what == "prefill":
                return tf.prefill(cut, p, x, frontend=f)
            return tf.forward_train(cut, p, tf.Batch(x, x, f))[0]
        zero_k7()
        with K7Log() as log:
            got = on(params, toks.to(dev), fe.to(dev))
        torch.cuda.synchronize()
        n_k7 = kfa.flash_attention.launches
        check(n_k7 == n_attn == kfa.flash_attention.launches_simt
              and log.count(False, "simt") == cut.n_encoder_layers
              and log.count(True, "simt") == cut.n_layers,
              f"{tag} {what}: {n_k7} K7 launches, calls {log.calls}, "
              f"expected {cut.n_encoder_layers} non-causal + "
              f"{cut.n_layers} causal simt")
        launches += n_k7
        want = on(params_cpu, toks, fe)
        msg = logits_agree(got.cpu(), want, torch.ones(got.shape[:2],
                                                       dtype=bool),
                           DENSE_TOL, f"{tag} {what}")
        print(f"{tag} {what}: card == CPU port: {msg}; {n_k7} K7 launches, "
              f"all simt ({cut.n_encoder_layers} non-causal at S = "
              f"{cut.encoder_seq}, {cut.n_layers} causal at S = {s})")

    # (b) prefill against a decode loop on the card, given the encoder K/V
    prompt = torch.from_numpy(rng.integers(
        0, cut.vocab_size, (1, AUDIO_DECODE_PROMPT))).to(dev)
    f1 = fe[:1].to(dev)
    want = tf.prefill(cut, params, prompt, frontend=f1)[0, -1]
    state = tf.init_serve_state(cut, 1, AUDIO_DECODE_PROMPT, dev)
    state = state._replace(enc_kv=tf._encode(cut, params, f1))
    zero_k7()
    for i in range(AUDIO_DECODE_PROMPT):
        logits, state = tf.decode_step(cut, params, state,
                                       prompt[:, i:i + 1])
    got = logits[0, -1]
    err = float((got - want).abs().max())
    check(kfa.flash_attention.launches == 0,
          f"{tag} the decode steps launched K7")
    check(torch.allclose(got, want, **DENSE_TOL)
          and int(got.argmax()) == int(want.argmax()),
          f"{tag} prefill vs decode_step on the card: max |diff| {err:.3g}")
    print(f"{tag} prefill == {AUDIO_DECODE_PROMPT} decode steps on the "
          f"card given the encoder K/V: last logits max |diff| {err:.3g} "
          f"(rtol = atol = {DENSE_TOL['atol']}), argmax equal, 0 K7 "
          f"launches in decode")
    del state, logits

    # (e, second half) the packed cut: built on both devices, card vs CPU
    packed = packing.pack_params_for_serving(params)
    packed_cpu = packing.pack_params_for_serving(params_cpu)
    leaves = tf.tree_leaves(packed)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        leaves, tf.tree_leaves(packed_cpu)))
    check(same, f"{tag} the packed tree built on the card differs from the "
          f"one built on the CPU")
    zero_k7()
    got = tf.prefill(cut, packed, toks.to(dev), frontend=fe.to(dev))
    torch.cuda.synchronize()
    n_k7 = kfa.flash_attention.launches
    check(n_k7 == n_attn, f"{tag} packed prefill: {n_k7} K7 launches")
    launches += n_k7
    want = tf.prefill(cut, packed_cpu, toks, frontend=fe)
    msg = logits_agree(got.cpu(), want, torch.ones(got.shape[:2], dtype=bool),
                       DENSE_TOL, f"{tag} packed prefill")
    print(f"{tag} packed (packed_fraction "
          f"{packing.packed_fraction(packed):.4f}): the card's tree == the "
          f"CPU's bit for bit ({len(leaves)} leaves); prefill card == CPU "
          f"port: {msg}; {n_k7} K7 launches")
    return launches


def audio_serve(eng, rng, tag: str, requests: int, swap_to=None):
    """Serve ``requests`` requests (prompt ``AUDIO_PROMPT``, ``AUDIO_NEW``
    new tokens, float32 frames drawn after each prompt, as the CLI draws
    them) through ``eng``; with ``swap_to``, hot-swap its weights after
    ``AUDIO_SWAP_AT`` steps. Returns (rids, outputs, prompts, frames, K7
    launches inside admissions' encodes, K7 launches in all, seconds)."""
    from repro_torch.kernels import flash_attention as kfa
    cfg, model = eng.cfg, eng.model
    in_encode = [0]
    encode = model.encode

    def counted(arrays, frames):
        n = kfa.flash_attention.launches
        out = encode(arrays, frames)
        in_encode[0] += kfa.flash_attention.launches - n
        return out
    model.encode = counted
    prompts, frames = [], []
    for _ in range(requests):
        prompts.append(rng.integers(0, cfg.vocab_size,
                                    (AUDIO_PROMPT,)).tolist())
        frames.append(rng.standard_normal(
            (cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    zero_k7()
    t0 = time.perf_counter()
    rids = [eng.submit(pr, max_new_tokens=AUDIO_NEW, frontend=f)
            for pr, f in zip(prompts, frames)]
    if swap_to is None:
        out = eng.run()
    else:
        out = eng.run(max_steps=AUDIO_SWAP_AT)
        eng.swap_params(swap_to())
        out.update(eng.run())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    model.encode = encode
    check(sorted(out) == sorted(rids) and all(
        len(out[r]) == AUDIO_NEW for r in rids),
        f"{tag} requests lost or short")
    return (rids, out, prompts, frames, in_encode[0],
            kfa.flash_attention.launches, dt)


def audio_full(full, rng, dev) -> tuple[int, int, list]:
    """Phase 7d (c): ``full`` whole in bf16, ``prefill`` at (1,
    ``FLASH_PATH_S``) on bf16 frames: 24 non-causal and 24 causal K7 tc
    launches required, timed (CUDA events), its peak memory read,
    profiled with K7's share, and the encoder's and the 24
    cross-attentions' kernel ms profiled apart. (d) Served at 4 slots
    with float32 frames: every request done, 24 K7 simt launches in each
    admission's encode and none in a decode step, request 0 equal to a
    hand-rolled decode loop, every reset slot's caches zero while the
    per-slot encoder K/V kept storage and contents; a decode step and an
    admission's encode profiled; a second seed's weights hot-swapped
    mid-run with every weight keeping its storage. (e) The served
    weights packed on the card (``serve/packing.py``): packed_fraction
    and weight bytes against bf16, served at 4 slots at quant
    binary_weights. Returns (K7 simt, K7 tc launches, summary rows)."""
    import gc

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import attention
    from repro_torch.models import transformer as tf
    from repro_torch.serve import packing
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.slots import latency_stats

    name = full.name
    n_enc, n_dec = full.n_encoder_layers, full.n_layers
    t0 = time.perf_counter()
    params = tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tf.tree_leaves(params))
    extra = audio_extra_params(full)
    bf16_bytes = dense_tree_bytes(params)
    print(f"[{name}] full: {n_enc} encoder + {n_dec} decoder layers, d "
          f"{full.d_model}, {n_par:,} parameters ({full.param_count():,} "
          f"counted by the config + {extra:,} it counts otherwise), "
          f"{bf16_bytes / 1e9:.3f} GB, made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_par == full.param_count() + extra,
          f"[{name}] parameter count differs from the config's")

    # (c) the bf16 prefill on bf16 frames: K7 tc in both stacks
    fe = torch.randn((1, full.encoder_seq, full.d_model),
                     generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev).to(torch.bfloat16)
    toks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                         (1, FLASH_PATH_S))).to(dev)

    def prefill():
        return tf.prefill(full, params, toks, frontend=fe)

    prefill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_k7()
    with K7Log() as log:
        logits = prefill()
    torch.cuda.synchronize()
    n_tc = kfa.flash_attention.launches_tc
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(n_tc == n_enc + n_dec == kfa.flash_attention.launches
          and log.count(False, "tc") == n_enc
          and log.count(True, "tc") == n_dec,
          f"[{name} prefill] {kfa.flash_attention.launches} K7 launches "
          f"({n_tc} tc), calls {log.calls}; expected {n_enc} non-causal + "
          f"{n_dec} causal tc")
    check(logits.shape == (1, 1, full.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(logits.isfinite().all()),
          f"[{name} prefill] logits malformed or not finite")
    shape = f"(1, {FLASH_PATH_S}), bf16 frames (1, {full.encoder_seq})"
    ev_ms = time_ms(prefill, reps=3, warmup=0)
    print(f"[{name} prefill] {shape}: logits finite, {n_tc} K7 launches, "
          f"all tc (hd {full.head_dim}: {n_enc} non-causal at S = "
          f"{full.encoder_seq}, {n_dec} causal at S = {FLASH_PATH_S}), "
          f"peak memory {peak:.2f} GB; CUDA events {ev_ms:.2f} ms per "
          f"prefill")
    wall, busy, n_launch, rows = profile_call(prefill, 2, f"prefill {shape}")
    k7_ms = sum(r[0] for r in rows if "flash_attention_tc" in r[2])
    _, enc_ms, enc_n, _ = profile_call(
        lambda: tf._encode(full, params, fe), 2,
        f"encoder alone, bf16 frames (1, {full.encoder_seq})")
    ek, ev = tf._encode(full, params, fe)
    layers_ = [tf._layer(params["stack0_dec_xattn"], i) for i in range(n_dec)]
    h = torch.randn((1, FLASH_PATH_S, full.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED)).to(torch.bfloat16)
    _, x_ms, x_n, _ = profile_call(
        lambda: [attention.cross_attn_forward(p["xattn"], full, h, ek[i],
                                              ev[i])
                 for i, p in enumerate(layers_)], 2,
        f"the {n_dec} cross-attentions alone at S = {FLASH_PATH_S}")
    print(f"  K7 tc: {k7_ms:.4f} ms of {busy:.4f} ms of kernels per prefill "
          f"({k7_ms / busy:.3f}); encoder {enc_ms:.4f} ms "
          f"({enc_ms / busy:.3f}, {enc_n} launches); cross-attention "
          f"{x_ms:.4f} ms ({x_ms / busy:.3f}, {x_n} launches)")
    table = [(f"prefill {shape}", n_launch, wall, busy, 1 - busy / wall,
              k7_ms / busy, x_ms / busy, peak)]
    del logits, ek, ev, h, layers_
    k7_simt, k7_tc = 0, n_tc

    # (d) served through the default TransformerServeModel, float32 frames
    eng = ServingEngine(full, params, n_slots=N_SLOTS,
                        max_len=AUDIO_MAX_LEN, device=dev)
    model = eng.model
    del params                         # the engine holds its own copy
    gc.collect()
    torch.cuda.empty_cache()
    enc_kv = eng.state.enc_kv
    enc_ptrs = [t.data_ptr() for t in enc_kv]
    check(all(t.dtype == torch.bfloat16 and tuple(t.shape) == (
        n_dec, N_SLOTS, full.encoder_seq, full.n_heads, full.head_dim)
        for t in enc_kv), f"[{name} serve] enc_kv malformed")
    resets = watch_resets(model)
    checked = model.reset_slot

    def keeps_enc_kv(state, i, n_slots):
        before = [t[:, i].clone() for t in state.enc_kv]
        state = checked(state, i, n_slots)
        check(all(torch.equal(a, t[:, i])
                  for a, t in zip(before, state.enc_kv)),
              f"[{name} serve] reset_slot changed slot {i}'s encoder K/V")
        return state
    model.reset_slot = keeps_enc_kv
    rids, out, prompts, frames, n_enc_k7, n_k7, dt = audio_serve(
        eng, rng, f"[{name} serve]", AUDIO_REQUESTS)
    check(n_enc_k7 == n_k7 == n_enc * AUDIO_REQUESTS
          == kfa.flash_attention.launches_simt,
          f"[{name} serve] {n_k7} K7 launches ({n_enc_k7} in admissions' "
          f"encodes, {kfa.flash_attention.launches_simt} simt), expected "
          f"{n_enc} simt per admission and none in decode")
    k7_simt += n_k7
    check(len(resets) == AUDIO_REQUESTS,
          f"[{name} serve] {len(resets)} slot resets checked, expected "
          f"{AUDIO_REQUESTS}")
    # request 0 by hand: slot 0's encoder K/V, then the decode loop
    state = model.init_state(N_SLOTS, AUDIO_MAX_LEN)
    f0 = torch.from_numpy(frames[0]).to(dev)[None]
    own = tuple(torch.zeros_like(t) for t in enc_kv)
    for dst, src in zip(own, model.encode(eng.params, f0)):
        dst[:, 0].copy_(src[:, 0])
    state = state._replace(enc_kv=own)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    alone: list[int] = []
    for i in range(AUDIO_PROMPT + AUDIO_NEW - 1):
        feed[0, 0] = prompts[0][i] if i < AUDIO_PROMPT else alone[-1]
        logits, state = model.decode_step(eng.params, state, feed)
        if i >= AUDIO_PROMPT - 1:
            alone.append(int(torch.argmax(logits[0, -1])))
    check(alone == out[rids[0]], f"[{name} serve] request 0's tokens "
          f"{out[rids[0]]} differ from a hand-rolled decode loop {alone}")
    st = latency_stats(eng.sched.finished)
    n_tok = sum(len(x) for x in out.values())
    steps = eng.steps_executed
    print(f"[{name} serve] {AUDIO_REQUESTS} requests (prompt "
          f"{AUDIO_PROMPT}, {AUDIO_NEW} new, float32 frames (1, "
          f"{full.encoder_seq}, {full.d_model})) through {N_SLOTS} slots in "
          f"{steps} steps: {n_enc} K7 simt launches per admission "
          f"({n_enc_k7} in all), 0 in decode; {len(resets)} slot resets "
          f"each read back zero in every cache tensor, the encoder K/V "
          f"untouched; request 0 equals a hand-rolled decode loop; "
          f"{n_tok / dt:.1f} tok/s, p50 {st['p50'] * 1e3:.1f} ms, p99 "
          f"{st['p99'] * 1e3:.1f} ms, {dt * 1e3 / steps:.2f} ms per step")
    zero_k7()
    wall, busy, n_launch, rows = profile_call(
        lambda: model.encode(eng.params, f0), 2,
        f"admission encode, float32 frames (1, {full.encoder_seq})")
    k7_ms = sum(r[0] for r in rows if "flash_simt" in r[2])
    table.append((f"admission encode, float32 frames (1, {full.encoder_seq})",
                  n_launch, wall, busy, 1 - busy / wall, k7_ms / busy, 0.0,
                  float("nan")))
    zero_k7()
    wall, busy, n_launch, rows = profile_call(
        lambda: model.decode_step(eng.params, state, feed), 3,
        f"decode step at {N_SLOTS} slots")
    check(kfa.flash_attention.launches == 0,
          f"[{name} serve] the profiled decode step launched K7")
    table.append((f"decode step, {N_SLOTS} slots", n_launch, wall, busy,
                  1 - busy / wall, 0.0, float("nan"), float("nan")))
    del state, logits, own

    # hot-swap a second seed's weights mid-run, in place
    ptrs = [x.data_ptr() for x in eng.params]

    def swap_to():
        return model.swap_arrays(tf.init_params(
            full, torch.Generator(device=dev).manual_seed(SEED + 1), dev))
    n_reset = len(resets)
    rids2, out2, _, _, n_enc_k7, n_k7, _ = audio_serve(
        eng, rng, f"[{name} swap]", AUDIO_REQUESTS, swap_to)
    gc.collect()
    torch.cuda.empty_cache()
    check([x.data_ptr() for x in eng.params] == ptrs,
          f"[{name} swap] a weight tensor changed storage")
    check([t.data_ptr() for t in eng.state.enc_kv] == enc_ptrs,
          f"[{name} swap] the encoder K/V changed storage")
    check(n_enc_k7 == n_k7 == n_enc * AUDIO_REQUESTS,
          f"[{name} swap] {n_k7} K7 launches, {n_enc_k7} in encodes")
    k7_simt += n_k7
    print(f"[{name} swap] hot-swap after {AUDIO_SWAP_AT} steps: all "
          f"{len(ptrs)} weight tensors and the 2 encoder K/V buffers kept "
          f"their storage (data_ptr); {len(resets) - n_reset} more slot "
          f"resets read back zero; {n_k7} K7 simt launches, all in "
          f"admissions")

    # (e) the served weights packed on the card, served at binary_weights
    tree = tf.tree_unflatten(model._spec, eng.params)
    t0 = time.perf_counter()
    packed = packing.pack_params_for_serving(tree)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    frac = packing.packed_fraction(packed)
    p_bytes = dense_tree_bytes(packed)
    del eng, model, tree
    gc.collect()
    torch.cuda.empty_cache()
    bw = full.with_(quant="binary_weights")
    peng = ServingEngine(bw, packed, n_slots=N_SLOTS, max_len=AUDIO_MAX_LEN,
                         device=dev)
    del packed
    rids3, out3, _, _, n_enc_k7, n_k7, dt = audio_serve(
        peng, rng, f"[{name} packed]", AUDIO_REQUESTS)
    check(n_enc_k7 == n_k7 == n_enc * AUDIO_REQUESTS,
          f"[{name} packed] {n_k7} K7 launches, {n_enc_k7} in encodes")
    k7_simt += n_k7
    steps = peng.steps_executed
    n_tok = sum(len(x) for x in out3.values())
    print(f"[{name} packed] serve/packing.py on the card in {pack_s:.2f} s: "
          f"packed_fraction {frac:.4f}, weights {p_bytes / 1e9:.3f} GB "
          f"against {bf16_bytes / 1e9:.3f} GB in bf16 "
          f"({bf16_bytes / p_bytes:.2f}x fewer bytes); served at quant "
          f"binary_weights, {AUDIO_REQUESTS} requests through {N_SLOTS} "
          f"slots in {steps} steps, {n_enc} K7 simt launches per admission, "
          f"{n_tok / dt:.1f} tok/s")
    state = peng.model.init_state(N_SLOTS, AUDIO_MAX_LEN)
    state = state._replace(enc_kv=peng.state.enc_kv)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    zero_k7()
    wall, busy, n_launch, _ = profile_call(
        lambda: peng.model.decode_step(peng.params, state, feed), 3,
        f"packed decode step at {N_SLOTS} slots")
    check(kfa.flash_attention.launches == 0,
          f"[{name} packed] the profiled decode step launched K7")
    table.append((f"packed decode step, {N_SLOTS} slots", n_launch, wall,
                  busy, 1 - busy / wall, 0.0, float("nan"), float("nan")))
    del peng, state
    gc.collect()
    torch.cuda.empty_cache()
    return k7_simt, k7_tc, table


def audio_phase(dev: torch.device) -> tuple[int, int]:
    """Phase 7d: the audio family, whisper-medium at full width on
    ``dev`` (``audio_cut``, then ``audio_full``). Returns the K7 launches
    (simt, tc) of its main-path runs: the cut's float32 forwards, the
    bf16 prefill, and every admission's encode."""
    import gc

    from repro_torch import configs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[audio] device memory held on entry: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED)
    full = configs.get_config(AUDIO_ARCH)
    simt = audio_cut(full, rng, dev)
    gc.collect()
    torch.cuda.empty_cache()
    n_simt, tc, table = audio_full(full, rng, dev)
    simt += n_simt
    print("[audio] call | launches | wall ms | kernel ms | idle | K7 share "
          "| cross-attention share | peak GB")
    for what, n, wall, busy, idle, k7, xattn, peak in table:
        print(f"[audio] {what} | {n} | {wall:.4f} | {busy:.4f} | {idle:.3f} "
              f"| {k7:.3f} | {xattn:.3f} | {peak:.2f}")
    print(f"[audio] phase 7d wall {time.perf_counter() - t_phase:.1f} s; "
          f"card: {smi('name,power.limit')}")
    return simt, tc


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in float64 on ``got``'s device (0 where both
    are 0)."""
    got, want = got.double(), want.to(got.device).double()
    den = float(want.norm())
    num = float((got - want).norm())
    return num / den if den else num


def train_step_check(dev) -> None:
    """One train step at full width and batch ``pc.TRAIN_BATCH`` from
    ``numpy_params`` latents, on the card and on the CPU: loss, gradients,
    Adam moments and running statistics held at ``TRAIN_STEP_TOL``, the
    updated weights and BN affines at ``TRAIN_ADAM_FLAT`` /
    ``TRAIN_SAME``."""
    from repro_torch.configs import bcnn_cifar10 as pc
    from repro_torch.core import bcnn
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.train import bcnn_train as bt
    from repro_torch.train import tree

    adamw = bt.make_adamw(pc.TRAIN_LR)
    params = bcnn.params_from_numpy(bcnn.numpy_params(SEED))
    state = bt.BCNNTrainState(params=params, opt=adamw.init(params))
    x, y = SyntheticImages(global_batch=pc.TRAIN_BATCH, seed=SEED).batch(0)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    step_fn = bt.make_train_step(adamw)
    out = {}
    for d in ("cpu", dev):
        st = bt.state_to(state, d)
        p = tree.tree_map(lambda t: t.detach().requires_grad_(), st.params)
        loss, _ = bcnn.loss_fn(p, x.to(d), y.to(d))
        grads = torch.autograd.grad(loss, tree.tree_leaves(p),
                                    allow_unused=True)
        new, _ = step_fn(st, x.to(d), y.to(d))
        out[d] = (loss.item(), grads, new)
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out[dev]
    gap = abs(l_gpu - l_cpu) / abs(l_cpu)
    check(gap <= TRAIN_STEP_TOL["loss"], f"[train step] loss card "
          f"{l_gpu!r} vs CPU {l_cpu!r}")
    g_gap = 0.0
    grads = {}
    for (key, _), a, b in zip(tree.leaves_with_path(params), g_gpu, g_cpu):
        if b is None:
            check(a is None, f"[train step] {key}: a gradient on the card "
                  f"only")
            continue
        grads["params/" + key] = (a.cpu(), b)
        g_gap = max(g_gap, rel_l2(a, b))
        check(rel_l2(a, b) <= TRAIN_STEP_TOL["grads"], f"[train step] "
              f"{key} gradient: relative L2 {rel_l2(a, b):.3g}")
    gaps = {"moments": 0.0, "running_stats": 0.0}
    worst_share, worst_diff, worst_key = 0.0, 0.0, ""
    flat_gpu = tree.leaves_with_path(s_gpu)
    for (key, a), b in zip(flat_gpu, tree.tree_leaves(s_cpu)):
        a = a.cpu()
        if key.startswith("opt/m/") or key.startswith("opt/v/"):
            kind = "moments"
        elif key.endswith("bn_mean") or key.endswith("bn_var"):
            kind = "running_stats"
        elif key == "opt/step":
            check(int(a) == int(b) == 1, "[train step] Adam step counter")
            continue
        else:                                    # weights and BN affines
            ga, gb = grads[key]
            diff = (a - b).abs()
            moved = diff > TRAIN_SAME
            free = (torch.sign(ga) != torch.sign(gb)) | (
                torch.maximum(ga.abs(), gb.abs()) < TRAIN_ADAM_FLAT)
            share = float(moved.double().mean())
            if share > worst_share:
                worst_share, worst_key = share, key
            worst_diff = max(worst_diff, float(diff.max()))
            check(not bool((moved & ~free).any())
                  and float(diff.max()) <= 2 * pc.TRAIN_LR + TRAIN_SAME,
                  f"[train step] {key}: {int((moved & ~free).sum())} "
                  f"elements differ where both gradients agree in sign; "
                  f"max |diff| {float(diff.max()):.3g}")
            continue
        gaps[kind] = max(gaps[kind], rel_l2(a, b))
        check(rel_l2(a, b) <= TRAIN_STEP_TOL[kind], f"[train step] {key}: "
              f"relative L2 {rel_l2(a, b):.3g}")
    print(f"[train step] full width, batch {pc.TRAIN_BATCH}, card == CPU: "
          f"loss {l_gpu:.6f} vs {l_cpu:.6f} (relative {gap:.2g}, limit "
          f"{TRAIN_STEP_TOL['loss']}); gradients worst relative L2 "
          f"{g_gap:.3g} (limit {TRAIN_STEP_TOL['grads']}); Adam moments "
          f"{gaps['moments']:.3g} ({TRAIN_STEP_TOL['moments']}); running "
          f"statistics {gaps['running_stats']:.3g} "
          f"({TRAIN_STEP_TOL['running_stats']}); weights and BN affines "
          f"differing by > {TRAIN_SAME} only where the gradients' signs "
          f"differ or |g| < {TRAIN_ADAM_FLAT}: at most {worst_share:.2e} "
          f"of a leaf ({worst_key}), max |diff| {worst_diff:.3g} (limit "
          f"2·lr = {2 * pc.TRAIN_LR})")


def pool_tie_check(dev) -> None:
    """The 2×2 max-pool's gradient on the card goes where the CPU's goes
    (the first maximum of a window in row-major order, as the reference's
    ``reduce_window``): CONV-2's integer pre-pool map at full width, batch
    8, ties and all, with one upstream gradient; bitwise."""
    from repro_torch.core import bcnn, bconv
    from repro_torch.data.pipeline import SyntheticImages

    params = bcnn.params_from_numpy(bcnn.numpy_params(SEED))
    x, _ = SyntheticImages(global_batch=8, seed=SEED).batch(0)
    a = bconv.fpconv_apply(params.conv1, torch.from_numpy(x))
    y = bconv.binary_conv(params.convs[0], a)
    r = torch.randn((8, 16, 16, y.shape[-1]),
                    generator=torch.Generator().manual_seed(SEED))
    grads = []
    for d in ("cpu", dev):
        yd = y.detach().to(d).requires_grad_()
        (g,) = torch.autograd.grad((bconv.maxpool2x2(yd) * r.to(d)).sum(),
                                   yd)
        grads.append(g.cpu())
    win = y.detach().reshape(8, 16, 2, 16, 2, -1)
    top = win.amax(dim=(2, 4), keepdim=True)
    ties = int(((win == top).sum(dim=(2, 4)) > 1).sum())
    check(torch.equal(grads[0], grads[1]), "[pool ties] the card's max-pool "
          "gradient differs from the CPU's")
    print(f"[pool ties] CONV-2 at batch 8: {ties} of {win.numel() // 4} "
          f"pool windows tie; the max-pool gradient on the card equals the "
          f"CPU's bitwise")


def train_phase(dev: torch.device) -> None:
    """Phase 8: the BCNN's training life cycle at full Table 2 width on
    the card ``dev``, and the XNOR LM's training forward."""
    import shutil

    from repro_torch import configs
    from repro_torch.configs import bcnn_cifar10 as pc
    from repro_torch.core import bcnn, bcnn_artifact
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import xnor_matmul as kmm
    from repro_torch.models import xnor_lm as xl
    from repro_torch.serve.bcnn_engine import BCNNEngine
    from repro_torch.train import bcnn_train as bt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import tree

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    card = smi("name,power.limit")
    with bt.exact_numerics():
        train_step_check(dev)
        pool_tie_check(dev)

    # --- the default recipe straight, then crashed at 120 and resumed
    kw = dict(steps=pc.TRAIN_STEPS, batch=pc.TRAIN_BATCH, lr=pc.TRAIN_LR,
              seed=SEED, verbose=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straight, info = bt.train(**kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = info["losses"]
    check(all(np.isfinite(v) for v in losses.values()), "[train] a loss "
          "is not finite")
    w = max(1, pc.TRAIN_STEPS // 10)
    first = np.mean([losses[s] for s in range(w)])
    last = np.mean([losses[s] for s in range(pc.TRAIN_STEPS - w,
                                                pc.TRAIN_STEPS)])
    check(last < first, f"[train] loss did not fall: mean of the first {w} "
          f"steps {first:.4f}, of the last {w} {last:.4f}")
    ck_dir = os.path.join(TRAIN_DIR, "ck")
    try:
        bt.train(**kw, ckpt_dir=ck_dir, ckpt_every=pc.TRAIN_CKPT_EVERY,
                 crash_at=TRAIN_CRASH_AT)
        check(False, "[train] the crash run did not crash")
    except bt.SimulatedCrash:
        pass
    resume_at = ckpt.latest_step(ck_dir)
    check(resume_at == TRAIN_CRASH_AT // pc.TRAIN_CKPT_EVERY
          * pc.TRAIN_CKPT_EVERY, f"[train] latest checkpoint {resume_at}")
    resumed, rinfo = bt.train(**kw, ckpt_dir=ck_dir,
                              ckpt_every=pc.TRAIN_CKPT_EVERY, resume=True)
    check(rinfo["start_step"] == resume_at, "[train] resumed elsewhere")
    pairs = list(zip(tree.leaves_with_path(straight),
                     tree.tree_leaves(resumed)))
    bad = [k for (k, a), b in pairs if not torch.equal(a, b)]
    check(len(pairs) == 136 and not bad, f"[train] resumed state differs "
          f"from the straight run's at {bad[:5]} ({len(bad)} of "
          f"{len(pairs)} leaves)")
    check(all(rinfo["losses"][s] == losses[s]
              for s in range(resume_at, pc.TRAIN_STEPS)),
          "[train] resumed losses differ from the straight run's")
    print(f"[train] {pc.TRAIN_STEPS} steps, batch {pc.TRAIN_BATCH}, lr "
          f"{pc.TRAIN_LR}: loss {losses[0]:.4f} -> "
          f"{losses[pc.TRAIN_STEPS - 1]:.4f} (mean of the first {w} steps "
          f"{first:.4f}, of the last {w} {last:.4f}); crashed after "
          f"{TRAIN_CRASH_AT}, resumed from step {resume_at}: all "
          f"{len(pairs)} leaves and losses of steps {resume_at}.."
          f"{pc.TRAIN_STEPS - 1} bitwise equal to the straight run")

    # --- timing: one step at the recipe's batch, and the loop's wall
    adamw = bt.make_adamw(pc.TRAIN_LR)
    step_fn = bt.make_train_step(adamw)
    x, y = SyntheticImages(global_batch=pc.TRAIN_BATCH, seed=SEED).batch(0)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    with bt.exact_numerics():
        step_ms = time_ms(lambda: step_fn(straight, x, y), reps=20,
                          warmup=3)
        print(f"[train] step at batch {pc.TRAIN_BATCH} ({card}): "
              f"{step_ms:.3f} ms between CUDA events, "
              f"{pc.TRAIN_BATCH / step_ms * 1e3:.1f} images/s; the "
              f"{pc.TRAIN_STEPS}-step loop {wall_s * 1e3 / pc.TRAIN_STEPS:.3f}"
              f" ms a step of host wall (data, step, loss read back)")
        profile_call(lambda: step_fn(straight, x, y), 3,
                     f"train step at batch {pc.TRAIN_BATCH}")

    # --- checkpoint bytes and save / restore time
    t0 = time.perf_counter()
    path = ckpt.save(os.path.join(TRAIN_DIR, "timed"), pc.TRAIN_STEPS,
                     straight)
    save_ms = (time.perf_counter() - t0) * 1e3
    n_bytes = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path))
    t0 = time.perf_counter()
    back, _ = ckpt.restore(os.path.join(TRAIN_DIR, "timed"), straight,
                           device=dev)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(tree.tree_leaves(back),
                                                 tree.tree_leaves(straight))),
          "[ckpt] restored state differs")
    print(f"[ckpt] {len(pairs)} leaves, {n_bytes} bytes: save "
          f"{save_ms:.1f} ms (fsync per file), restore onto the card "
          f"{restore_ms:.1f} ms, bitwise equal")

    # --- the fold gate through the hand kernels, every route
    counters = bcnn_counters()
    params = straight.params
    for fusion in (False, True):
        for path_ in ("mxu", "vpu"):
            tag = f"evaluate {path_}{' fused' if fusion else ''}"
            for fn in counters.values():
                fn.launches = 0
            ev = bt.evaluate(params, batch=pc.TRAIN_BATCH, seed=SEED,
                             n_batches=4, path=path_, conv_fusion=fusion)
            torch.cuda.synchronize()
            seen = {k: fn.launches for k, fn in counters.items()}
            want = {k: 4 * n for k, n in forward_launches(SimpleNamespace(
                path=path_, conv_fusion=fusion)).items()}
            check(all(seen[k] == v for k, v in want.items()) and all(
                v == 0 for k, v in seen.items() if k not in want),
                f"[{tag}] launches {seen}, expected {want}")
            check(ev["agree"] >= bt.MIN_FOLD_AGREEMENT, f"[{tag}] top-1 "
                  f"agreement {ev['agree']} < {bt.MIN_FOLD_AGREEMENT}")
            print(f"[{tag}] {ev['n']} held-out images: top-1 agreement "
                  f"{ev['agree']:.4f} (gate {bt.MIN_FOLD_AGREEMENT}), "
                  f"accuracy {ev['acc_eval']:.4f} training graph / "
                  f"{ev['acc_packed']:.4f} deployment; launches {seen}")

    # --- export the artifact and serve it
    art = os.path.join(TRAIN_DIR, "art")
    bcnn_artifact.save_packed(art, bcnn.fold_model(params),
                              provenance={"trainer": "chip_smoke.py"})
    eng = BCNNEngine.from_packed(bcnn_artifact.load_packed(art),
                                 n_slots=N_SLOTS, device=dev)
    eng.warmup()
    x_np, _ = SyntheticImages(global_batch=N_REQUESTS,
                              seed=SEED).batch(20_000)
    rids = [eng.submit(img) for img in x_np]
    out = eng.run()
    check(sorted(out) == sorted(rids), "[artifact] requests lost")
    served = np.stack([out[r] for r in rids])
    want = eager_logits(eng.forward, x_np)
    check(served.shape == (N_REQUESTS, 10) and np.isfinite(served).all()
          and np.array_equal(served, want), "[artifact] served logits "
          "differ from forward_packed's")
    print(f"[artifact] trained net exported, reloaded and served: "
          f"{N_REQUESTS} requests through {N_SLOTS} slots "
          f"(step_cache_size {eng.step_cache_size}), logits bitwise equal "
          f"to forward_packed on the card")
    eng.close()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # --- the XNOR LM: forward_train == forward_packed on the card
    cfg = configs.get_config("xnor-lm-tiny")
    lm = tree.tree_map(lambda t: t.to(dev), xl.params_from_numpy(
        xl.numpy_params(cfg, SEED)))
    packed = xl.fold(cfg, lm)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, TRAIN_LM_TOKENS)).to(dev)
    want = xl.forward_train(cfg, lm, toks)
    check(want.shape == (*TRAIN_LM_TOKENS, cfg.vocab_size)
          and bool(want.isfinite().all()), "[lm train] logits malformed")
    lm_counters = {"binary_weight_matmul": kmm.binary_weight_matmul,
                   "xnor_matmul_vpu": kmm.xnor_matmul_vpu,
                   "xnor_matmul_mxu": kmm.xnor_matmul_mxu}
    for mode, path_, kernel in (("bw", "mxu", "binary_weight_matmul"),
                                ("xnor", "vpu", "xnor_matmul_vpu"),
                                ("xnor", "mxu", "xnor_matmul_mxu")):
        for fn in lm_counters.values():
            fn.launches = 0
        got = xl.forward_packed(cfg, packed, toks, mode=mode, path=path_)
        torch.cuda.synchronize()
        seen = {k: fn.launches for k, fn in lm_counters.items()}
        check(seen[kernel] == 6 * cfg.n_layers and all(
            v == 0 for k, v in seen.items() if k != kernel),
            f"[lm train] {mode}/{path_} launches {seen}")
        check(torch.equal(got, want), f"[lm train] forward_packed "
              f"{mode}/{path_} differs from forward_train: max "
              f"{float((got - want).abs().max()):.3g}")
        print(f"[lm train] CONFIG, tokens {TRAIN_LM_TOKENS}: forward_train "
              f"== forward_packed {mode}/{path_} bitwise on the card "
              f"({seen[kernel]} {kernel} launches)")
    print(f"card: {card}")


def lm_step_check(cfg, tokens, dev, tag: str) -> None:
    """Phase 8b (a): one ``make_train_step`` step of ``cfg`` from the same
    weights on the CPU and on the card ``dev``, on ``SyntheticLM``'s first
    batch of ``tokens`` (with the family's stub frontend): the loss at
    ``LM_STEP_TOL["loss"]``, every gradient leaf, both Adam moments and
    every updated weight within relative L2 ``LM_STEP_TOL["leaf"]``; no
    K7 launch in the card's step (counters zeroed just before and read
    just after). The moe cut records both routers: every token must take
    the same experts on both devices (``route_keep`` at
    ``MOE_ROUTE_MARGIN``, no position left out)."""
    import contextlib
    import gc

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.train import frontend_shape
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop, tree

    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_par = sum(t.numel() for t in tree.tree_leaves(params))
    batch = SyntheticLM(cfg.vocab_size, tokens[1], tokens[0], seed=SEED,
                        frontend=frontend_shape(cfg)).batch(0)
    adamw = opt_lib.AdamW(lr=LM_TRAIN_LR)
    step = train_loop.make_train_step(cfg, adamw, keep_grads=True)
    routes = RouteLog if cfg.family == "moe" else contextlib.nullcontext
    t0 = time.perf_counter()
    cpu = tree.tree_map(lambda t: t.cpu(), params)
    with routes() as cpu_routes:
        want, want_m = step(train_loop.TrainState(cpu, adamw.init(cpu),
                                                  None), batch)
    del cpu
    gc.collect()
    cpu_s = time.perf_counter() - t0
    zero_k7()
    with routes() as card_routes:
        got, got_m = step(train_loop.TrainState(params, adamw.init(params),
                                                None), batch)
        torch.cuda.synchronize()
    n_k7 = kfa.flash_attention.launches
    check(n_k7 == 0, f"{tag} {n_k7} K7 launches inside a train step")
    del params
    if cfg.family == "moe":
        keep, gaps = route_keep(card_routes, cpu_routes, cfg.top_k,
                                MOE_ROUTE_MARGIN, tag)
        check(bool(keep.all()), f"{tag} routing differs at near-ties "
              f"{gaps}: the step's gradients are not comparable")
    loss, want_loss = float(got_m["loss"]), float(want_m["loss"])
    gap = abs(loss - want_loss) / abs(want_loss)
    check(np.isfinite(loss) and gap <= LM_STEP_TOL["loss"],
          f"{tag} loss card {loss!r} vs CPU {want_loss!r}")
    worst, flat = {}, 0
    # the CPU's results move to the card leaf by leaf; the gaps are
    # computed there in float64
    pairs = [("grads", got_m["grads"], want_m["grads"]),
             ("weights", got.params, want.params),
             ("moments", {"m": got.opt.m, "v": got.opt.v},
              {"m": want.opt.m, "v": want.opt.v})]
    grads = {k: (g_cpu, g_card) for (k, g_cpu), g_card in zip(
        tree.leaves_with_path(want_m["grads"]),
        tree.tree_leaves(got_m["grads"]))}
    for kind, a_tree, b_tree in pairs:
        for (key, a), b in zip(tree.leaves_with_path(a_tree),
                               tree.tree_leaves(b_tree)):
            b = b.to(dev)
            if kind == "weights":
                # Adam's first step moves a weight by lr·g / (|g| + eps):
                # where both gradients lie below TRAIN_ADAM_FLAT that ratio
                # is decided by rounding (zero-initialised biases show it);
                # such elements may differ by at most 2·lr
                g_cpu, g_card = grads[key]
                free = torch.maximum(g_cpu.to(dev).abs(), g_card.abs()) < (
                    TRAIN_ADAM_FLAT)
                diff = (a - b).abs()
                check(float(diff.masked_fill(~free, 0).max())
                      <= 2 * LM_TRAIN_LR + TRAIN_SAME,
                      f"{tag} weights {key}: a flat element moved by more "
                      f"than 2·lr")
                flat += int((free & (diff > TRAIN_SAME)).sum())
                a, b = a.masked_fill(free, 0), b.masked_fill(free, 0)
            gap_l = rel_l2(a, b)
            check(gap_l <= LM_STEP_TOL["leaf"], f"{tag} {kind} {key}: "
                  f"relative L2 {gap_l:.3g}")
            if gap_l >= worst.get(kind, (0.0, ""))[0]:
                worst[kind] = (gap_l, key)
    check(int(got.opt.step) == int(want.opt.step) == 1,
          f"{tag} Adam step counter")
    print(f"{tag} one train step, {n_par:,} parameters, tokens {tokens}, "
          f"card == CPU: loss {loss:.6f} vs {want_loss:.6f} (relative "
          f"{gap:.2g}, limit {LM_STEP_TOL['loss']}); worst relative L2 "
          + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst.items())
          + f" (limit {LM_STEP_TOL['leaf']}; {flat} weight elements "
          f"differ by more than {TRAIN_SAME} where both gradients lie below "
          f"{TRAIN_ADAM_FLAT}, held to 2·lr); 0 K7 launches in the step; "
          f"CPU step {cpu_s:.1f} s")
    del got, want, got_m, want_m
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_run(cut, dev):
    """Phase 8b (b): ``cut`` trained ``LM_TRAIN_STEPS`` steps under
    ``exact_numerics`` straight, then crashed after ``LM_TRAIN_CRASH_AT``
    and resumed from its checkpoint; every leaf of the final
    ``TrainState`` and every overlapping loss bitwise equal, the loss
    falling, no K7 launch; the step timed, profiled and its peak memory
    read; the checkpoint's bytes and save / restore times. Returns the
    straight run's final state."""
    import gc
    import shutil

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train as train_launch
    from repro_torch.train import bcnn_train as bt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop, tree

    b, s = LM_TRAIN_TOKENS
    tag = f"[lm train {LM_TRAIN_LAYERS}L]"
    kw = dict(steps=LM_TRAIN_STEPS, batch=b, seq=s, lr=LM_TRAIN_LR,
              seed=SEED, device=dev, exact=True, log_every=5)
    zero_k7()
    straight, info = train_launch.train(cut, **kw)
    torch.cuda.synchronize()
    check(kfa.flash_attention.launches == 0, f"{tag} the train loop "
          f"launched K7")
    losses = info["losses"]
    check(all(np.isfinite(v) for v in losses.values()), f"{tag} a loss is "
          f"not finite")
    first = float(np.mean([losses[i] for i in range(5)]))
    last = float(np.mean([losses[i] for i in range(LM_TRAIN_STEPS - 5,
                                                   LM_TRAIN_STEPS)]))
    check(last < first, f"{tag} loss did not fall: mean of the first 5 "
          f"steps {first:.4f}, of the last 5 {last:.4f}")
    n_par = sum(t.numel() for t in tree.tree_leaves(straight.params))
    print(f"{tag} {cut.name} at full width, {cut.n_layers} layers, "
          f"{n_par:,} parameters, bf16, remat, tokens {LM_TRAIN_TOKENS}, "
          f"lr {LM_TRAIN_LR}: loss {losses[0]:.4f} -> "
          f"{losses[LM_TRAIN_STEPS - 1]:.4f} (mean of the first 5 steps "
          f"{first:.4f}, of the last 5 {last:.4f}); {info['seconds']:.1f} s "
          f"of host wall for {LM_TRAIN_STEPS} steps")

    # the step: device time between CUDA events, peak memory, profile
    adamw = opt_lib.AdamW(lr=LM_TRAIN_LR)
    step_fn = train_loop.make_train_step(cut, adamw)
    batch = SyntheticLM(cut.vocab_size, s, b, seed=SEED).batch(0)
    batch = type(batch)(*(None if a is None else a.to(dev) for a in batch))
    card = smi("name,power.limit")
    with bt.exact_numerics():
        step_ms = time_ms(lambda: step_fn(straight, batch), reps=3, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(straight, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"{tag} step at {LM_TRAIN_TOKENS} ({card}): {step_ms:.2f} ms "
              f"between CUDA events, {b * s / step_ms * 1e3:,.0f} tokens/s, "
              f"peak memory {peak / 1e9:.2f} GB")
        profile_call(lambda: step_fn(straight, batch), 1,
                     f"train step at {LM_TRAIN_TOKENS}")
    del batch
    # the straight run's state waits on the host for the comparison
    straight = tree.tree_map(lambda t: None if t is None else t.cpu(),
                             straight)
    gc.collect()
    torch.cuda.empty_cache()

    # crashed after LM_TRAIN_CRASH_AT, resumed from its checkpoint
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    ck_dir = os.path.join(LM_TRAIN_DIR, "ck")
    saves, restores = [], []
    real_save, real_restore = ckpt.save, ckpt.restore

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = real_save(*a, **k)
        saves.append((time.perf_counter() - t0, sum(
            os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))))
        return out

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = real_restore(*a, **k)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out
    ckpt.save, ckpt.restore = timed_save, timed_restore
    try:
        try:
            train_launch.train(cut, **kw, ckpt_dir=ck_dir, keep=1,
                               ckpt_every=LM_TRAIN_CKPT_EVERY,
                               crash_at=LM_TRAIN_CRASH_AT, verbose=False)
            check(False, f"{tag} the crash run did not crash")
        except bt.SimulatedCrash:
            pass
        gc.collect()
        torch.cuda.empty_cache()
        resume_at = ckpt.latest_step(ck_dir)
        check(resume_at == LM_TRAIN_CRASH_AT, f"{tag} latest checkpoint "
              f"{resume_at}")
        # the resumed run writes no checkpoint of its own (a 20 GB write)
        resumed, rinfo = train_launch.train(
            cut, **kw, ckpt_dir=ck_dir, keep=1,
            ckpt_every=LM_TRAIN_STEPS + 1, resume=True, verbose=False)
    finally:
        ckpt.save, ckpt.restore = real_save, real_restore
    check(rinfo["start_step"] == resume_at, f"{tag} resumed elsewhere")
    pairs = list(zip(tree.leaves_with_path(straight),
                     tree.tree_leaves(resumed)))
    bad = [k for (k, a), r in pairs
           if not (a is None and r is None or torch.equal(a, r.cpu()))]
    check(not bad, f"{tag} resumed state differs from the straight run's "
          f"at {bad[:5]} ({len(bad)} of {len(pairs)} leaves)")
    check(all(rinfo["losses"][i] == losses[i]
              for i in range(resume_at, LM_TRAIN_STEPS)),
          f"{tag} resumed losses differ from the straight run's")
    save_s, n_bytes = saves[-1]
    print(f"{tag} crashed after step {LM_TRAIN_CRASH_AT}, resumed from "
          f"step {resume_at}: all {len(pairs)} leaves of the TrainState and "
          f"the losses of steps {resume_at}..{LM_TRAIN_STEPS - 1} bitwise "
          f"equal to the straight run (exact_numerics)")
    print(f"[lm ckpt] TrainState of {len(pairs)} leaves, {n_bytes:,} bytes: "
          f"save {save_s * 1e3:.1f} ms (fsync per file; "
          f"{len(saves)} saves, {', '.join(f'{t:.1f}' for t, _ in saves)} s)"
          f", restore onto the card {restores[0] * 1e3:.1f} ms ({card})")
    del straight
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    gc.collect()
    return resumed


def lm_train_phase(dev: torch.device) -> int:
    """Phase 8b: LM training of the zoo on ``dev`` (``lm_step_check`` for
    each family, ``lm_train_run``, the trained weights through K7, the
    binary-weights cut trained, packed and served, the CLI). Returns the
    K7 launches (all "tc") of its main-path forwards."""
    import gc

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import packing
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train import tree

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = smi("name,power.limit")
    full = configs.get_config(DENSE_ARCH)

    # --- (a) one step, card vs CPU, every family's float32 cut
    t0 = time.perf_counter()
    lm_step_check(full.with_(n_layers=2, dtype="float32", remat=False),
                  LM_STEP_TOKENS, dev, f"[lm step {DENSE_ARCH} 2L]")
    for arch, layers, tokens in LM_STEP_CUTS:
        cfg = configs.get_config(arch).with_(n_layers=layers,
                                             dtype="float32", remat=False)
        if cfg.family == "audio":
            cfg = cfg.with_(n_encoder_layers=layers)
        lm_step_check(cfg, tokens, dev, f"[lm step {arch} {layers}L]")
    print(f"[lm step] (a) {time.perf_counter() - t0:.1f} s")

    # --- (b) the 4-layer bf16 cut trained at full width
    cut = full.with_(n_layers=LM_TRAIN_LAYERS)
    state = lm_train_run(cut, dev)

    # --- (c) the trained weights through K7 tc vs the blockwise path
    b = SyntheticLM(cut.vocab_size, LM_TRAIN_K7_TOKENS[1],
                    LM_TRAIN_K7_TOKENS[0], seed=SEED).batch(LM_TRAIN_STEPS)
    b = type(b)(*(None if a is None else a.to(dev) for a in b))
    zero_k7()
    with torch.no_grad():
        k7_logits = tf.forward_train(cut, state.params, b)[0]
        torch.cuda.synchronize()
    n_k7, n_tc = kfa.flash_attention.launches, kfa.flash_attention.launches_tc
    check(n_k7 == n_tc == cut.n_layers, f"[lm k7] {n_k7} K7 launches "
          f"({n_tc} tc), expected {cut.n_layers} tc")
    live = tree.tree_map(lambda t: t.detach().requires_grad_(), state.params)
    zero_k7()
    plain = tf.forward_train(cut, live, b)[0].detach()
    check(kfa.flash_attention.launches == 0, "[lm k7] the forward under "
          "autograd launched K7")
    del live
    gap = rel_l2(k7_logits, plain)
    agree = float((k7_logits.argmax(-1) == plain.argmax(-1)).double().mean())
    check(bool(k7_logits.isfinite().all()) and gap <= LM_TRAIN_K7_GAP,
          f"[lm k7] trained weights: K7 vs blockwise logits relative L2 "
          f"{gap:.4g} > {LM_TRAIN_K7_GAP}")
    print(f"[lm k7] the step-{LM_TRAIN_STEPS} weights, tokens "
          f"{LM_TRAIN_K7_TOKENS}: forward_train under no_grad through "
          f"{n_k7} K7 tc launches vs the blockwise path under autograd (0 "
          f"launches): logits relative L2 {gap:.4g} (limit "
          f"{LM_TRAIN_K7_GAP}), argmax agreement {agree:.4f}")
    del state, k7_logits, plain, b
    gc.collect()
    torch.cuda.empty_cache()

    # --- (d) binary weights: train, pack, serve
    bw = cut.with_(quant="binary_weights")
    nb, s = LM_TRAIN_TOKENS
    zero_k7()
    state, info = train_launch.train(bw, steps=LM_TRAIN_BW_STEPS, batch=nb,
                                     seq=s, lr=LM_TRAIN_LR, seed=SEED,
                                     device=dev, verbose=False)
    check(kfa.flash_attention.launches == 0, "[lm bw] the train loop "
          "launched K7")
    ls = info["losses"]
    first = float(np.mean([ls[i] for i in range(3)]))
    last = float(np.mean([ls[i] for i in range(LM_TRAIN_BW_STEPS - 3,
                                               LM_TRAIN_BW_STEPS)]))
    check(all(np.isfinite(v) for v in ls.values()) and last < first,
          f"[lm bw] loss did not fall: first 3 {first:.4f}, last 3 "
          f"{last:.4f}")
    latent = state.params
    del state
    gc.collect()
    torch.cuda.empty_cache()
    packed = packing.pack_params_for_serving(latent)
    frac = packing.packed_fraction(packed)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, bw.vocab_size,
                                         LM_PACKED_PROMPT)).to(dev)
    k7_tc = n_k7
    with torch.no_grad():
        out = {}
        for what, tree_ in (("packed", packed), ("latent", latent)):
            zero_k7()
            out[what] = tf.prefill(bw, tree_, toks).float().cpu()
            torch.cuda.synchronize()
            check(kfa.flash_attention.launches_tc == bw.n_layers
                  == kfa.flash_attention.launches,
                  f"[lm bw] {what} prefill: "
                  f"{kfa.flash_attention.launches} K7 launches")
            k7_tc += kfa.flash_attention.launches
    msg = logits_agree(out["packed"], out["latent"],
                       torch.ones(out["packed"].shape[:2], dtype=torch.bool),
                       MOE_BF16_TOL, "[lm bw] packed vs latent STE prefill")
    del latent
    gc.collect()
    torch.cuda.empty_cache()
    prompts = [rng.integers(0, bw.vocab_size, (RECURRENT_PROMPT,)).tolist()
               for _ in range(RECURRENT_REQUESTS)]
    eng = ServingEngine(bw, packed, n_slots=N_SLOTS,
                        max_len=RECURRENT_MAX_LEN, device=dev)
    model = eng.model
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    zero_k7()
    rids = [eng.submit(pr, max_new_tokens=RECURRENT_NEW) for pr in prompts]
    served = eng.run()
    check(sorted(served) == sorted(rids) and all(
        len(served[r]) == RECURRENT_NEW for r in rids), "[lm bw serve] "
        "requests lost or short")
    check(kfa.flash_attention.launches == 0, "[lm bw serve] the decode "
          "path launched K7")
    state = model.init_state(N_SLOTS, RECURRENT_MAX_LEN)
    feed = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device=dev)
    alone: list[int] = []
    for i in range(RECURRENT_PROMPT + RECURRENT_NEW - 1):
        feed[0, 0] = prompts[0][i] if i < RECURRENT_PROMPT else alone[-1]
        logits, state = model.decode_step(eng.params, state, feed)
        if i >= RECURRENT_PROMPT - 1:
            alone.append(int(torch.argmax(logits[0, -1])))
    check(alone == served[rids[0]], f"[lm bw serve] request 0's tokens "
          f"{served[rids[0]]} differ from a hand-rolled decode loop {alone}")
    print(f"[lm bw] {bw.name} {bw.n_layers} layers at quant binary_weights: "
          f"{LM_TRAIN_BW_STEPS} steps at {LM_TRAIN_TOKENS}, loss "
          f"{ls[0]:.4f} -> {ls[LM_TRAIN_BW_STEPS - 1]:.4f} (first 3 "
          f"{first:.4f}, last 3 {last:.4f}); packed (packed_fraction "
          f"{frac:.4f}); prefill {LM_PACKED_PROMPT} packed vs latent STE "
          f"tree: {msg}; served {RECURRENT_REQUESTS} requests through "
          f"{N_SLOTS} slots, request 0 equal to a hand-rolled decode loop "
          f"on the packed tree, 0 K7 launches in decode")
    del eng, model, state, logits
    gc.collect()
    torch.cuda.empty_cache()

    # --- (e) the CLI on the card: a crash after step 2, then --resume
    ck_dir = os.path.join(LM_TRAIN_DIR, "cli")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           DENSE_ARCH, "--smoke", "--steps", "4", "--ckpt-dir", ck_dir,
           "--ckpt-every", "2", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r1 = subprocess.run(cmd + ["--crash-at", "2"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    r2 = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    check(r1.returncode != 0 and "simulated fault after step 2" in r1.stderr,
          f"[lm cli] the crash run: rc {r1.returncode}, {r1.stderr[-500:]}")
    check(r2.returncode == 0 and "[resume] restored step 2" in r2.stdout
          and "step     4  loss=" in r2.stdout
          and os.path.isdir(os.path.join(ck_dir, "step_00000004")),
          f"[lm cli] the resumed run: rc {r2.returncode}, "
          f"{r2.stdout[-500:]} {r2.stderr[-500:]}")
    print(f"[lm cli] python -m repro_torch.launch.train --arch {DENSE_ARCH} "
          f"--smoke on the card: crashed after step 2, --resume restored "
          f"step 2 and ran to step 4 ({cli_s:.1f} s for both processes); "
          f"last line: {r2.stdout.strip().splitlines()[-2]}")
    import shutil
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    print(f"[lm train] phase 8b wall {time.perf_counter() - t_phase:.1f} s; "
          f"card: {card}")
    return k7_tc


def stage_stack(stack: dict, s: int, lps: int) -> dict:
    from repro_torch.train.tree import tree_map
    return tree_map(lambda a: a[s * lps:(s + 1) * lps], stack)


def lm_multi_phase(dev: torch.device, prefill_kernel_ms: float
                   ) -> tuple[int, int]:
    """Phase 9: the LM zoo's multi-device forms on ``dev``. Returns K7's
    launches (simt, tc) of its pipelined forwards: (b)'s float32 cut and
    (a)'s full-depth bf16 run (the main path's)."""
    import gc

    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import pipeline as pp
    from repro_torch.parallel import sharding

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = smi("name,power.limit")
    full = configs.get_config(DENSE_ARCH)
    rng = np.random.default_rng(SEED)

    def layer_fn(cfg, s: int, device):
        pos = torch.arange(s, device=device)[None]
        return lambda lp, h: tf._apply_dense_attn(lp, cfg, h, pos)

    # --- (a) full width and depth, bf16, 4 stages side by side
    bounds = pp.plan_stages(full, MULTI_LM_STAGES)
    lps = full.n_layers // MULTI_LM_STAGES
    check(bounds == [s * lps for s in range(MULTI_LM_STAGES + 1)],
          f"[lm pipeline] plan_stages {bounds} is not {MULTI_LM_STAGES} "
          f"even stages")
    mesh = mesh_lib.make_mesh((MULTI_LM_STAGES,), ("stage",),
                              devices=[dev] * MULTI_LM_STAGES)
    params = tf.init_params(
        full, torch.Generator(device=dev).manual_seed(SEED), dev)
    stack = params["stack0_dense_attn"]
    toks = torch.from_numpy(rng.integers(
        0, full.vocab_size, (MULTI_LM_MICRO, *MULTI_LM_TOKENS))).to(dev)
    x = layers.embed_lookup(params["embed"], toks)   # (n_micro, B, S, D)
    fn = layer_fn(full, MULTI_LM_TOKENS[1], dev)

    def pipelined():
        return pp.pipelined_forward(stack, x, mesh=mesh, axis="stage",
                                    apply_fn=fn, layers_per_stage=lps)

    def sequential():
        return pp.sequential_forward(stack, x, apply_fn=fn)

    with torch.no_grad():
        pipelined()                                       # warm
        torch.cuda.synchronize()
        zero_k7()
        got = pipelined()
        torch.cuda.synchronize()
        n_tc = kfa.flash_attention.launches_tc
        want_tc = full.n_layers * MULTI_LM_MICRO
        check(n_tc == want_tc == kfa.flash_attention.launches,
              f"[lm pipeline] {kfa.flash_attention.launches} K7 launches "
              f"({n_tc} tc), expected {want_tc} tc")
        seq = sequential()
        check(torch.equal(got, seq), "[lm pipeline] pipelined_forward != "
              "sequential_forward: max |diff| "
              f"{float((got.float() - seq.float()).abs().max()):.3g}")
        pos = torch.arange(MULTI_LM_TOKENS[1], device=dev)[None]
        for m in range(MULTI_LM_MICRO):
            h, _ = tf._decoder_stack(full, params, x[m], pos)
            check(torch.equal(seq[m], h), f"[lm pipeline] microbatch {m}: "
                  f"sequential_forward != _decoder_stack")
        check(bool(got.isfinite().all()), "[lm pipeline] not finite")
        print(f"[lm pipeline] {DENSE_ARCH} full width and depth, bf16: "
              f"{MULTI_LM_MICRO} microbatches of {MULTI_LM_TOKENS} tokens "
              f"through {MULTI_LM_STAGES} stages of {lps} layers "
              f"(plan_stages {bounds}) side by side on the card: bitwise "
              f"== sequential_forward == _decoder_stack per microbatch; "
              f"{n_tc} K7 launches, all tc ({full.n_layers} layers x "
              f"{MULTI_LM_MICRO} microbatches)")
        for name, f in (("pipelined", pipelined), ("sequential", sequential)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                f()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            ev = time_ms(f, reps=5, warmup=1)
            print(f"[lm pipeline] {name}: wall {wall:.2f} ms, CUDA events "
                  f"{ev:.2f} ms per forward of {MULTI_LM_MICRO} x "
                  f"{MULTI_LM_TOKENS} tokens "
                  f"({MULTI_LM_MICRO * MULTI_LM_TOKENS[1] / ev * 1e3:.0f} "
                  f"tokens/s)")
            profile_call(f, 2, f"{name} forward")
        stage_ms = [time_ms(lambda s=s: pp.sequential_forward(
            stage_stack(stack, s, lps), x[:1], apply_fn=fn), reps=5,
            warmup=1) for s in range(MULTI_LM_STAGES)]
        print(f"[lm pipeline] each stage alone, one microbatch, CUDA "
              f"events: {', '.join(f'{t:.3f}' for t in stage_ms)} ms")
        hq, hkv, hd = full.n_heads, full.n_kv_heads, full.head_dim
        s_len = MULTI_LM_TOKENS[1]
        q, k, v = (torch.randn((1, s_len, h, hd), dtype=torch.bfloat16,
                               device=dev).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        check(all(kfa.tma_ready(t) for t in (q, k, v)),
              "[lm pipeline] K7 views not tma_ready")
        k7_ms = device_ms(lambda: kfa.flash_attention(q, k, v))
        b_bytes, b_ops = flash_bound(1, hq, hkv, hd, s_len, True,
                                     torch.bfloat16)
        print(f"[lm pipeline] K7 tc alone at (1, {hq}, {hkv}, {hd}), S = "
              f"{s_len}, causal, bf16 views: {k7_ms:.4f} ms per call "
              f"(device), bound {max(b_bytes, b_ops):.4f} ms "
              f"({'bytes' if b_bytes > b_ops else 'operations'})")
        del q, k, v, got, seq, h

        # --- (c) the dry run's one-device report of a prefill (1, 4096)
        shape = InputShape("prefill", DENSE_PREFILL[1], DENSE_PREFILL[0],
                           "prefill")
        local = mesh_lib.make_local_mesh(dev)
        res = dryrun_lib.run_cell(DENSE_ARCH, shape, mesh=local)
        check(res.ok, f"[lm dryrun] {res.error}")
        abstract = dryrun_lib.abstract_params(full)
        param_b = sharding.local_bytes(
            abstract, sharding.param_specs(abstract, local), local)
        card_b = dense_tree_bytes(params)
        check(param_b == card_b, f"[lm dryrun] param bytes {param_b} != "
              f"the card's tree {card_b}")
        ptoks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                              DENSE_PREFILL)).to(dev)
        del x
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tf.prefill(full, params, ptoks)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        resident = res.arg_bytes
        print(f"[lm dryrun] {DENSE_ARCH} prefill {DENSE_PREFILL} on "
              f"make_local_mesh: param bytes {param_b} == the card's tree "
              f"{card_b}; traced {res.hlo_flops:.6g} FLOP, {res.hlo_bytes:.6g}"
              f" bytes; phase 7's kernel time {prefill_kernel_ms:.4f} ms -> "
              f"{res.hlo_flops / prefill_kernel_ms / 1e9:.1f} TFLOP/s "
              f"achieved (t_compute {res.t_compute * 1e3:.4f} ms, "
              f"t_memory {res.t_memory * 1e3:.4f} ms at the data sheet's "
              f"rates; bottleneck {res.bottleneck}); resident "
              f"{resident / 1e9:.4f} GB + temp {res.temp_bytes / 1e9:.4f} GB "
              f"= {(resident + res.temp_bytes) / 1e9:.4f} GB vs measured "
              f"max_memory_allocated {peak / 1e9:.4f} GB; fits "
              f"{res.fits}; traced in {res.compile_s:.1f} s")
    del params, stack, ptoks
    gc.collect()
    torch.cuda.empty_cache()

    # --- (b) 2 layers at full width, float32: 2 stages on the card vs CPU
    cut = full.with_(n_layers=2, dtype="float32")
    params = tf.init_params(
        cut, torch.Generator(device=dev).manual_seed(SEED), dev)
    stack = params["stack0_dense_attn"]
    toks = torch.from_numpy(rng.integers(0, cut.vocab_size,
                                         DENSE_CPU_TOKENS)).to(dev)
    x = layers.embed_lookup(params["embed"], toks)[:, None]
    cut_mesh = mesh_lib.make_mesh((2,), ("stage",), devices=[dev] * 2)
    with torch.no_grad():
        fn = layer_fn(cut, DENSE_CPU_TOKENS[1], dev)
        zero_k7()
        got = pp.pipelined_forward(stack, x, mesh=cut_mesh, axis="stage",
                                   apply_fn=fn, layers_per_stage=1)
        torch.cuda.synchronize()
        n_simt = kfa.flash_attention.launches_simt
        want_simt = cut.n_layers * DENSE_CPU_TOKENS[0]
        check(n_simt == want_simt == kfa.flash_attention.launches,
              f"[lm pipeline cut] {kfa.flash_attention.launches} K7 "
              f"launches ({n_simt} simt), expected {want_simt} simt")
        check(torch.equal(got, pp.sequential_forward(stack, x, apply_fn=fn)),
              "[lm pipeline cut] pipelined != sequential on the card")
        cpu = torch.device("cpu")
        want = pp.sequential_forward(
            tf.tree_map(lambda a: a.cpu(), stack), x.cpu(),
            apply_fn=layer_fn(cut, DENSE_CPU_TOKENS[1], cpu))
    got = got.cpu()
    err = float((got - want).abs().max())
    check(bool(got.isfinite().all()) and torch.allclose(got, want,
                                                        **DENSE_TOL),
          f"[lm pipeline cut] card vs CPU: max |diff| {err:.3g}")
    print(f"[lm pipeline cut] {DENSE_ARCH} cut to 2 layers, float32, "
          f"{DENSE_CPU_TOKENS[0]} microbatches of (1, {DENSE_CPU_TOKENS[1]}) "
          f"through 2 stages on the card == the CPU port's "
          f"sequential_forward: max |diff| {err:.3g} (rtol = atol = "
          f"{DENSE_TOL['atol']}); {n_simt} K7 launches, all simt (hd "
          f"{cut.head_dim})")
    del params, stack, x
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm pipeline] phase 9 wall {time.perf_counter() - t_phase:.1f} "
          f"s; card: {card}")
    return n_simt, n_tc


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs one CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    # deterministic cuBLAS for the trainer (phase 8): read once, before
    # this process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    walls: list[tuple[str, float]] = []

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls.append((name, time.perf_counter() - t0))
        print(f"[wall] phase {name}: {walls[-1][1]:.1f} s")
        return out

    dev = torch.device("cuda")
    timed("1", build_phase)
    timed("1 (probe)", probe_phase)
    stats = timed("2", kernel_phase, Bound())
    reference = cpu_reference()
    launches = timed("3", serve_phase, reference)
    tuned = timed("4", tune_phase, reference)
    timed("5", fleet_phase, reference, tuned)
    timed("5b", multi_phase, reference, tuned)
    launches["binary_weight_matmul"] = timed("6", lm_phase)
    launches["flash_attention"], launches["flash_attention_tc"], \
        prefill_ms = timed("7", dense_phase)
    launches["flash_attention_tc"] += timed("7b", moe_phase, dev)
    launches["flash_attention"] += timed("7c", recurrent_phase, dev)
    simt, tc = timed("7d", audio_phase, dev)
    launches["flash_attention"] += simt
    launches["flash_attention_tc"] += tc
    timed("8", train_phase, dev)
    launches["flash_attention_tc"] += timed("8b", lm_train_phase, dev)
    simt, tc = timed("9", lm_multi_phase, dev, prefill_ms)
    launches["flash_attention"] += simt
    launches["flash_attention_tc"] += tc
    print("[wall] " + ", ".join(f"{n} {t:.1f} s" for n, t in walls)
          + f"; total {sum(t for _, t in walls):.1f} s")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
