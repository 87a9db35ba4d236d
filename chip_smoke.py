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

Phase 2 also holds K7 against its plain version at the dense LM's
attention shape (B, Hq, Hkv, hd) = (1, 32, 8, 128), causal, S in {128,
1000, 4096}, at the same heads with hd 32, 96, 112 and 192 at S = 4096,
and at the ragged extras (2, 4, 2, 64) at S = 256, (1, 2, 1, 64) at S =
200, both causal settings, (1, 4, 2, hd) at S = 300 for hd 32, 96, 112
and 192, (1, 2, 1, 256) at S = 200 non-causal and (1, 2, 2, 33) at S = 65
(rows the wrapper pads to 16 bytes), in float32 and bfloat16 (tolerances
``FLASH_TOL``), each in the variant ``pick_variant`` chooses (printed
from the launch counters): "tc" (``flash_attention_tc``, bf16 at hd 64 /
128) on contiguous tensors and on the strided head-major views the model
hands over, "simt" (``flash_attention``) on everything else. Before them
it prints the "simt" plan of every hd bucket from the card
(``kfa.simt_plan``: blocks an SM by the occupancy API, registers and
local bytes a thread, shared bytes, KV tile) and requires 2 blocks an SM
at hd <= 128 in float32; the build phase prints ptxas's line of every
``flash_simt_kernel`` instantiation. It times every row against one
``scaled_dot_product_attention`` call on the same inputs (a yardstick the
port never calls); the kernels line takes each variant at S = 4096 in the
dtype it serves there (tc bf16) and simt at ``FLASH_SIMT_PATH``. Then it
runs "tc" at the reference's ``prefill_32k`` length (S = 32768, causal,
bf16), which the plain version cannot hold (137 GB of scores), against
SDPA's output at the bf16 tolerances.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SLOTS = 4
N_REQUESTS = 16
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 rate
# and dense int8 tensor-core rate. Integer issue rates per SM per clock
# for compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput): population count 16, 32-bit bitwise operations
# and adds 64.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
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
            "bf16": BF16_FLOPS_PER_S / 2,
        }
        print(f"bound model: {self.sms} SMs at {clock_mhz:.0f} MHz max SM "
              f"clock; vpu: per 16-byte unit ({u['bits']} bit-MACs) "
              f"{u['lop3']} LOP3 + {u['iadd3']} IADD3 at "
              f"{ALU_PER_CLK_PER_SM} and {u['popc']} POPC at "
              f"{POPC_PER_CLK_PER_SM} a clock per SM -> {unit_clk:.4g} "
              f"clocks, {self.bitmacs_per_s['vpu']:.4g} bit-MAC/s; int8 "
              f"MMA {self.bitmacs_per_s['mxu']:.4g} MAC/s; HBM "
              f"{HBM_BYTES_PER_S:.3g} B/s")

    def __call__(self, variant: str, nbytes: int, bitmacs: int):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
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


def flash_bound(b, hq, hkv, hd, s, causal, dtype):
    """(bytes ms, operations ms) of one attention call: Q, K and V read
    once, O written once, at the HBM rate; 4·B·Hq·hd FLOP per kept (query,
    key) pair (S(S+1)/2 of them when causal) at the dense tensor-core rate
    of bf16, or at the float32 CUDA-core rate (67 TFLOP/s) for float32."""
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * b * hq + 2 * b * hkv) * s * hd * esize
    kept = s * (s + 1) // 2 if causal else s * s
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4 * b * hq * hd * kept / rate * 1e3)


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
    the kernel's tensor maps read in place. Times every row (on the views
    where the variant is "tc") beside the plain version and SDPA on the
    same inputs; the kernels line takes "tc" at S = ``FLASH_PATH_S`` in
    bf16 and "simt" at ``FLASH_SIMT_PATH`` in float32. Then "tc" at
    ``FLASH_LONG`` against SDPA's output, at the same tolerances. Uses no
    more of the package than the wrapper, its launch counters and the
    plain version, so it runs on an older checkout's ``src`` too."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    for b, hq, hkv, hd, s, causal in FLASH_CASES:
        for dt in (torch.float32, torch.bfloat16):
            picked = kfa.pick_variant(dt, hd)
            name = FLASH_NAMES[picked]
            case = (f"(B, Hq, Hkv, hd) = {(b, hq, hkv, hd)}, S = {s}, "
                    f"causal = {causal}, {str(dt)[6:]}")
            layouts = ["contiguous"] + (["views"] if picked == "tc" else [])
            for layout in layouts:
                if layout == "views":
                    q, k, v = (torch.randn((b, s, h, hd), generator=g).to(
                        dev, dt).transpose(1, 2) for h in (hq, hkv, hkv))
                    check(kfa.tma_ready(q) and not q.is_contiguous(),
                          f"K7 {case}: the views are not read in place")
                else:
                    q, k, v = (torch.randn((b, h, s, hd), generator=g).to(
                        dev, dt) for h in (hq, hkv, hkv))
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
                t_b, t_o = flash_bound(b, hq, hkv, hd, s, causal, dt)
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
                if ((picked == "tc" and s == FLASH_PATH_S) or (
                        picked == "simt"
                        and (b, hq, hkv, hd, s, causal) == FLASH_SIMT_PATH)):
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
    from repro_torch.models import transformer
    return sum(x.numel() * x.element_size()
               for x in transformer.tree_leaves(params))


def profile_call(fn, n: int, what: str) -> tuple[float, float, int]:
    """Host wall ms per call of ``fn`` (``n`` calls ending in a sync), the
    profiler's device kernel ms per call, and launches per call; prints
    them with the device's idle share (1 - kernel time / wall) and the top
    kernels. A call of the dense LM launches over a thousand kernels, more
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
        return wall_ms, float("nan"), 0
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"  {what}: {launches} launches, wall {wall_ms:.4f} ms, device "
          f"(kernel sum) {busy:.4f} ms, device idle share "
          f"{1 - busy / wall_ms:.3f}; top kernels (torch.profiler):")
    for ms, count, key in rows[:10]:
        print(f"    {ms:.4f} ms  x{count}  {key[:90]}")
    return wall_ms, busy, launches


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


def dense_phase() -> tuple[int, int]:
    """Phase 7: the dense LM zoo at Qwen3-8B's full width. Returns K7's
    launch counts (simt, tc): "simt" from the float32 two-layer cut's
    ``prefill``, "tc" from the full-depth bf16 prefill (the main path's
    run)."""
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
    profile_call(prefill, 2, f"prefill {DENSE_PREFILL}")
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
    return simt_launches, k7_launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs one CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    build_phase()
    probe_phase()
    stats = kernel_phase(Bound())
    reference = cpu_reference()
    launches = serve_phase(reference)
    fleet_phase(reference, tune_phase(reference))
    launches["binary_weight_matmul"] = lm_phase()
    launches["flash_attention"], launches["flash_attention_tc"] = (
        dense_phase())
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
