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

The reference's executable ``shard_map`` pipeline of the LM layers comes
with the LM trainer. The same planning, applied to the paper's own
heterogeneous 9-layer BCNN and executed over a list of devices, lives in
``parallel/bcnn_pipeline.py``.
"""
from __future__ import annotations

from repro_torch.core.throughput import balance_stages


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
