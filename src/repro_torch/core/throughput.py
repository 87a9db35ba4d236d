"""The paper's throughput optimization model (§4.3, eqs. 9–12) + Table 3
(counterpart of ``repro/core/throughput.py``: pure Python, kept as the
port's own copy).

    Cycle_conv = WID·HEI·DEP·FW·FH·FD                     (eq. 9)
    Cycle_est  = Cycle_conv / (UF·P) · I                  (eq. 11)
    throughput = freq / max(C_1 … C_k)                    (eq. 12)

and the paper's optimization procedure: the reduction loop is unfolded along
FW and FD ("fully unfolded for maximizing the throughput", §6), spatial
parallelism P is assigned to equalize per-layer Cycle_est (optimal hardware
utilization ⇔ equal stage times).

The same bottleneck-stage structure cuts layer stacks into pipeline stages:
``parallel/pipeline.py`` for the LMs and ``parallel/bcnn_pipeline.py`` for
the BCNN, where eq. 12 is the steady-state rate law of a micro-batch
pipeline, with C_l = per-stage step time. tests/test_torch_throughput.py
holds every function to the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# --- Paper constants -------------------------------------------------------

FREQ_HZ = 90e6          # paper §6.2: 90 MHz system clock
PAPER_FPS = 6218        # paper §6.2
PAPER_TOPS = 7.663      # paper abstract/Table 5
PAPER_POWER_W = 8.2     # paper abstract


@dataclass(frozen=True)
class ConvLayerDims:
    """Output-feature-map dims (pre-pooling) + filter dims, per paper eq. 9."""
    name: str
    wid: int   # output width  (pre-pool)
    hei: int   # output height (pre-pool)
    dep: int   # output depth = number of filters
    fw: int    # filter width
    fh: int    # filter height
    fd: int    # filter depth = input channels
    maxpool: bool = False


# Paper Table 2 → the six convolutional layers of the CIFAR-10 BCNN.
BCNN_CONV_LAYERS = (
    ConvLayerDims("Conv 1", 32, 32, 128, 3, 3, 3),
    ConvLayerDims("Conv 2", 32, 32, 128, 3, 3, 128, maxpool=True),
    ConvLayerDims("Conv 3", 16, 16, 256, 3, 3, 128),
    ConvLayerDims("Conv 4", 16, 16, 256, 3, 3, 256, maxpool=True),
    ConvLayerDims("Conv 5", 8, 8, 512, 3, 3, 256),
    ConvLayerDims("Conv 6", 8, 8, 512, 3, 3, 512, maxpool=True),
)

# Paper Table 3: (UF, P, Cycle_conv, Cycle_est, Cycle_r)
PAPER_TABLE3 = {
    "Conv 1": (27, 32, 3538944, 4096, 5233),
    "Conv 2": (384, 32, 150994944, 12288, 12386),
    "Conv 3": (384, 16, 75497472, 12288, 12296),
    "Conv 4": (768, 16, 150994944, 12288, 13329),
    "Conv 5": (768, 8, 75497472, 12288, 12386),
    "Conv 6": (1536, 8, 150994944, 12288, 14473),
}


# --- eqs. 9–12 --------------------------------------------------------------

def cycle_conv(d: ConvLayerDims) -> int:
    """Eq. (9): serial cycle count of one convolutional layer."""
    return d.wid * d.hei * d.dep * d.fw * d.fh * d.fd


def cycle_est(d: ConvLayerDims, uf: int, p: int, i: int = 1) -> int:
    """Eq. (11): cycles with unfolding UF, spatial parallelism P, interval I."""
    return cycle_conv(d) * i // (uf * p)


def system_throughput_fps(cycles_per_layer: dict[str, int],
                          freq_hz: float = FREQ_HZ) -> float:
    """Eq. (12): the bottleneck layer sets the streaming rate."""
    return freq_hz / max(cycles_per_layer.values())


BCNN_FC_SPECS = ((8192, 1024), (1024, 1024), (1024, 10))


def ops_per_image(layers=BCNN_CONV_LAYERS, fcs=BCNN_FC_SPECS) -> int:
    """Total binary ops (1 XNOR + 1 accumulate per weight position).

    Includes the FC layers: 6218 FPS × this = 7.67 TOPS, matching the paper's
    7.663 TOPS to 0.15% (the residual is the paper's undocumented rounding).
    """
    return 2 * (sum(cycle_conv(d) for d in layers)
                + sum(i * o for i, o in fcs))


def tops(fps: float, layers=BCNN_CONV_LAYERS) -> float:
    return fps * ops_per_image(layers) / 1e12


# --- The paper's parameter-optimization procedure ---------------------------

def paper_uf(d: ConvLayerDims, first_layer: bool = False) -> int:
    """§6: FW and FD dims fully unfolded (whole filter for the tiny layer 1)."""
    return d.fw * d.fh * d.fd if first_layer else d.fw * d.fd


def optimize_parallelism(layers=BCNN_CONV_LAYERS, *, pe_budget: int = 112,
                         i: int = 1) -> dict[str, tuple[int, int, int]]:
    """Choose per-layer P (power of two) to equalize Cycle_est under a PE
    budget (sum of P), reproducing the paper's balance procedure (§4.3:
    "increase the parallelism of the Lᵗʰ layer while decreasing that of other
    layers"). Two phases:

    1. *Throughput phase*: lowering max(Cycle_est) requires doubling P of
       **every** layer currently tied at the bottleneck; do so while the PE
       budget allows.
    2. *Latency phase*: spend leftover budget doubling the largest-est
       non-bottleneck layer (the paper gives Conv 1 P=32 although P=16
       already meets the 12288 bottleneck — pure pipeline-latency spend).

    Returns {name: (UF, P, Cycle_est)}. With the default budget (Σ P = 112,
    the paper's Table 3 allocation) this reproduces Table 3 exactly.
    """
    ufs = {d.name: paper_uf(d, first_layer=(idx == 0))
           for idx, d in enumerate(layers)}
    ps = {d.name: 1 for d in layers}
    dims = {d.name: d for d in layers}

    def est(name):
        return cycle_est(dims[name], ufs[name], ps[name], i)

    # Phase 1: lower the bottleneck while it fits.
    while True:
        bott_val = max(est(n) for n in ps)
        tied = [n for n in ps if est(n) == bott_val]
        cost = sum(ps[n] for n in tied)
        if sum(ps.values()) + cost > pe_budget:
            break
        for n in tied:
            ps[n] *= 2
    # Phase 2: leftover budget → worst *non-bottleneck* layer that fits.
    # Doubling a single member of the tied bottleneck set buys no throughput
    # (eq. 12) — spend on latency of the slowest non-bottleneck instead.
    while True:
        bott_val = max(est(n) for n in ps)
        fitting = [n for n in ps if est(n) < bott_val
                   and sum(ps.values()) + ps[n] <= pe_budget]
        if not fitting:
            break
        ps[max(fitting, key=est)] *= 2
    return {n: (ufs[n], ps[n], est(n)) for n in ps}


def reproduce_table3() -> dict[str, tuple[int, int, int, int]]:
    """(UF, P, Cycle_conv, Cycle_est) per layer with the paper's parameters."""
    out = {}
    for d in BCNN_CONV_LAYERS:
        uf, p, _, _, _ = PAPER_TABLE3[d.name]
        out[d.name] = (uf, p, cycle_conv(d), cycle_est(d, uf, p))
    return out


# --- Generalization: bottleneck-balanced stage partitioning -----------------

def balance_stages(costs: list[float], n_stages: int) -> list[int]:
    """Partition a layer-cost sequence into contiguous stages minimizing the
    eq. 12 bottleneck max(C_s). Exact DP (O(L²·S)); used by parallel/pipeline
    to assign transformer layers to pipeline stages.

    Returns stage boundaries: list of n_stages+1 indices into ``costs``.
    """
    n = len(costs)
    assert 1 <= n_stages <= n, (n_stages, n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def span(a, b):  # cost of layers [a, b)
        return prefix[b] - prefix[a]

    INF = float("inf")
    # dp[s][j] = minimal bottleneck for first j layers in s stages
    dp = [[INF] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(s, n + 1):
            for a in range(s - 1, j):
                v = max(dp[s - 1][a], span(a, j))
                if v < dp[s][j]:
                    dp[s][j] = v
                    cut[s][j] = a
    bounds = [n]
    j = n
    for s in range(n_stages, 0, -1):
        j = cut[s][j]
        bounds.append(j)
    return bounds[::-1]


def pipeline_throughput(costs: list[float], bounds: list[int],
                        freq_hz: float = 1.0) -> float:
    """Eq. (12) applied to a stage partition."""
    stage_costs = [sum(costs[bounds[i]:bounds[i + 1]])
                   for i in range(len(bounds) - 1)]
    return freq_hz / max(stage_costs)
