"""Pipeline parallelism: the paper's eq. 12 bottleneck law applied to
transformer stages (counterpart of the analytic half of
``repro/parallel/pipeline.py``).

The paper's central architectural rule — system throughput = freq /
max(C_1..C_k), optimized by equalizing per-stage time (§4.3) — is exactly
the steady-state law of a 1F1B microbatch pipeline. This module reuses
``core/throughput.py::balance_stages`` (the same DP used to reproduce
Table 3) to cut a transformer's per-layer cost sequence into stages:

* ``layer_costs`` / ``plan_stages``  — analytic per-layer cost → boundaries
* ``stage_costs_from_bounds``, ``schedule_1f1b`` — bubble/throughput model
* ``elastic_stage_plan``             — re-balance when the width changes
* ``pipelined_forward``              — the executable pipeline of a stacked
  layer forward over a mesh axis (``launch/mesh.py``), and
  ``sequential_forward``, its oracle

The reference's pipeline is a ``shard_map`` over a device mesh whose
stages hand activations on by ``ppermute``. Here stage s runs on the
mesh's s-th device along the axis, on a stream of its own, and hands each
microbatch to stage s + 1 behind a CUDA event (the counterpart of the
double-buffered ``ppermute``), as ``parallel/bcnn_pipeline.py`` streams
the BCNN. The same planning, applied to the paper's own heterogeneous
9-layer BCNN, lives there.
"""
from __future__ import annotations

import torch

from repro_torch.core.throughput import balance_stages
from repro_torch.kernels import streams as stream_pool
from repro_torch.train.tree import tree_leaves, tree_map


def layer_costs(cfg, seq_len: int) -> list[float]:
    """Per-layer forward FLOPs (the C_l of eq. 12 for a transformer).

    ``cfg`` is any LM config from ``repro_torch.configs`` (dense, SwiGLU,
    or MoE — MoE layers are costed at their activated-expert FLOPs);
    ``seq_len`` sets the attention term. Returns one cost per layer,
    length ``cfg.n_layers``. The BCNN analogue — per-layer binary-op
    counts from the paper's Table 2 — lives in
    ``parallel/bcnn_pipeline.py``.
    """
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.head_dim
    n_q = cfg.n_heads * hd
    n_kv = cfg.n_kv_heads * hd
    attn = 2.0 * (d * n_q + 2 * d * n_kv + n_q * d) + 4.0 * seq_len * d
    if cfg.is_moe:
        ffn = 2.0 * 3 * d * cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
    else:
        ffn = 2.0 * (3 if cfg.mlp_type == "swiglu" else 2) * d * f
    return [attn + ffn] * cfg.n_layers


def plan_stages(cfg, n_stages: int, seq_len: int = 4096) -> list[int]:
    """Stage boundaries (len n_stages+1) minimizing the eq. 12 bottleneck.

    Thin wrapper: ``layer_costs`` → ``core/throughput.py::balance_stages``
    (the exact DP also used for the paper's Table 3). ``bounds[s]:bounds[s+1]``
    is the half-open layer range of stage ``s``.
    """
    return balance_stages(layer_costs(cfg, seq_len), n_stages)


def stage_costs_from_bounds(costs: list[float],
                            bounds: list[int]) -> list[float]:
    """Per-stage summed cost for a ``balance_stages`` partition.

    ``costs`` are per-layer costs; ``bounds`` the n_stages+1 boundary
    indices. The max of the result is the eq. 12 bottleneck C_max that
    sets steady-state pipeline throughput.
    """
    return [float(sum(costs[bounds[i]:bounds[i + 1]]))
            for i in range(len(bounds) - 1)]


def schedule_1f1b(stage_costs: list[float], n_micro: int, *,
                  fwd_bwd_mult: float = 3.0) -> dict:
    """Steady-state model of the microbatch pipeline schedule.

    ``stage_costs`` are per-stage forward costs (any consistent unit),
    ``n_micro`` the number of microbatches in flight per step, and
    ``fwd_bwd_mult`` the per-microbatch work multiple relative to one
    forward: 3.0 models training 1F1B (fwd + ~2× bwd, the default, used by
    the LM pipeline), 1.0 models the inference-only fill/drain pipeline
    (``parallel/bcnn_pipeline.py`` — the paper's streaming deployment,
    where every tick is a forward).

    Returns a dict with ``bubble_fraction`` (fill/drain idle share),
    ``steady_rate`` (microbatches per unit time once full — the paper's
    eq. 12 corresponds to the n_micro→∞ limit, rate = 1/C_max),
    ``efficiency`` (ideal/real step time), and ``balance``
    (mean/max stage cost; 1.0 ⇔ perfectly equalized stages, the §4.3
    optimality condition).
    """
    s = len(stage_costs)
    c_max = max(stage_costs)
    total = sum(stage_costs)
    # per-microbatch cost = fwd_bwd_mult × fwd; fill+drain = (s−1) slots
    t_ideal = n_micro * fwd_bwd_mult * c_max
    t_real = t_ideal + (s - 1) * fwd_bwd_mult * c_max
    bubble = (s - 1) / (n_micro + s - 1)
    return {"bubble_fraction": bubble,
            "steady_rate": 1.0 / (fwd_bwd_mult * c_max),
            "efficiency": t_ideal / t_real,
            "balance": total / (s * c_max)}


def elastic_stage_plan(costs: list[float], n_stages_old: int,
                       n_stages_new: int) -> tuple[list[int], list[int]]:
    """Re-balance stages when the pipeline width changes (elastic scaling).

    ``costs`` are per-layer costs (``layer_costs`` or any other model);
    ``n_stages_old``/``n_stages_new`` the pipeline widths before and after.
    Returns (old_bounds, new_bounds); parameters move between stages
    according to the boundary diff (the minimal re-layout of an elastic
    restore).
    """
    return (balance_stages(costs, n_stages_old),
            balance_stages(costs, n_stages_new))


# ---------------------------------------------------------------------------
# the executable pipeline
# ---------------------------------------------------------------------------

def _apply_layers(stack, h: torch.Tensor, apply_fn) -> torch.Tensor:
    """``apply_fn`` over every layer of the (n, …) ``stack``, in order."""
    for i in range(tree_leaves(stack)[0].shape[0]):
        h = apply_fn(tree_map(lambda a: a[i], stack), h)
    return h


def pipelined_forward(stack_params, x: torch.Tensor, *, mesh, axis: str,
                      apply_fn, layers_per_stage: int) -> torch.Tensor:
    """Run a stacked-layer forward as a stage pipeline over ``axis``.

    stack_params: tree stacked (L, …) with L = n_stages · layers_per_stage;
    x: (n_micro, B, S, D) microbatched activations, n_micro a multiple of
    the stages; ``apply_fn(layer_params, h) → h`` applies ONE layer.
    Stage s owns layers [s·lps, (s+1)·lps) and runs on
    ``mesh.axis_devices(axis)[s]``; the result lands on x's device.

    Classic loop: at tick t, stage s processes microbatch t−s; stages go
    back to front within a tick, so a stage reads its predecessor's output
    of the previous tick. On CUDA each stage runs on a pooled stream
    (``kernels/streams.py``) ordered after the caller's current stream,
    the caller waits for every stage before this returns, and each
    hand-off waits for the event its producer recorded after writing it;
    a hand-off read on another stream is recorded there
    (``record_stream``), so its memory is not reused before that read.
    On the CPU the same schedule runs eagerly. Each microbatch meets the
    same layers in the same order as in ``sequential_forward``, so on one
    device the two are bitwise equal.
    """
    # bcnn_pipeline imports this module's planners
    from repro_torch.parallel.bcnn_pipeline import on_stream, ordered

    n_stages = mesh.shape[axis]
    n_micro = x.shape[0]
    if n_micro % n_stages:
        raise ValueError(f"{n_micro} microbatches are not a multiple of "
                         f"{n_stages} stages")
    n_layers = tree_leaves(stack_params)[0].shape[0]
    if n_layers != n_stages * layers_per_stage:
        raise ValueError(f"{n_layers} layers != {n_stages} stages x "
                         f"{layers_per_stage} layers per stage")
    devices = mesh.axis_devices(axis)
    lps = layers_per_stage
    params = [tree_map(lambda a: a[s * lps:(s + 1) * lps].to(d), stack_params)
              for s, d in enumerate(devices)]
    cuda = x.is_cuda
    pooled = [stream_pool.acquire(d) if cuda else None for d in devices]
    out = torch.empty_like(x)
    try:
        with ordered(x.device, [s for s in pooled if s is not None]):
            ready = [torch.cuda.Event() if cuda else None for _ in devices]
            hand = [None] * n_stages
            for t in range(n_micro + n_stages - 1):
                for s in reversed(range(n_stages)):
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue
                    with on_stream(pooled[s]):
                        if s == 0:
                            h = x[m].to(devices[0])
                        else:
                            if cuda:
                                pooled[s].wait_event(ready[s - 1])
                                hand[s - 1].record_stream(pooled[s])
                            h = hand[s - 1].to(devices[s])
                        h = _apply_layers(params[s], h, apply_fn)
                        if s + 1 < n_stages:
                            hand[s] = h
                            if cuda:
                                ready[s].record(pooled[s])
                        else:
                            out[m].copy_(h)
    finally:
        for st in pooled:
            if st is not None:
                stream_pool.release(st)
    return out


def sequential_forward(stack_params, x: torch.Tensor, *, apply_fn):
    """Reference: the same stacked layers without pipelining.

    ``stack_params`` is the (L, …) stacked tree ``pipelined_forward``
    takes; ``x`` is either one microbatch (ndim ≤ 2) or a stack of them,
    each run through all L layers in turn (the reference's ``vmap`` over
    the leading axis). The bitwise oracle of the pipeline.
    """
    if x.ndim <= 2:
        return _apply_layers(stack_params, x, apply_fn)
    return torch.stack([_apply_layers(stack_params, mb, apply_fn)
                        for mb in x])
