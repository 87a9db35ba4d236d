"""The port's copy of the §4.3 throughput model (``core/throughput.py``)
and the analytic half of the LM stage planner (``parallel/pipeline.py``)
against the reference.

The first seven tests are ``tests/test_throughput.py`` case for case, run
on the port's module; the rest require exactly the reference's results
(pure Python on both sides, so equality, not a tolerance): Table 3, the
balance DP on seeded random costs, and the LM stage plans on the same
configurations, the MoE one built from the reference's fields.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import throughput as jtp
from repro.parallel import pipeline as jpp
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.core import throughput as tp
from repro_torch.parallel import pipeline as pp


# ------------------------------------------ tests/test_throughput.py's cases
def test_cycle_conv_matches_table3():
    for d in tp.BCNN_CONV_LAYERS:
        uf, p, cc, ce, _ = tp.PAPER_TABLE3[d.name]
        assert tp.cycle_conv(d) == cc, d.name


def test_cycle_est_matches_table3():
    for d in tp.BCNN_CONV_LAYERS:
        uf, p, _, ce, _ = tp.PAPER_TABLE3[d.name]
        assert tp.cycle_est(d, uf, p) == ce, d.name


def test_paper_uf_rule():
    """§6: 'operations along the FW and FD dimensions are fully unfolded'."""
    for idx, d in enumerate(tp.BCNN_CONV_LAYERS):
        uf_paper = tp.PAPER_TABLE3[d.name][0]
        assert tp.paper_uf(d, first_layer=(idx == 0)) == uf_paper, d.name


def test_system_fps_and_tops():
    """Eq. 12 with the reported Cycle_r reproduces 6218 FPS / 7.663 TOPS."""
    cycles_r = {n: v[4] for n, v in tp.PAPER_TABLE3.items()}
    fps = tp.system_throughput_fps(cycles_r)
    assert abs(fps - tp.PAPER_FPS) < 1.0, fps
    assert abs(tp.tops(fps) - tp.PAPER_TOPS) < 0.015, tp.tops(fps)


def test_optimizer_reproduces_paper_allocation():
    """Greedy bottleneck-doubling under the paper's ΣP=112 budget → Table 3."""
    alloc = tp.optimize_parallelism()
    for name, (uf, p, ce) in alloc.items():
        uf_p, p_p, _, ce_p, _ = tp.PAPER_TABLE3[name]
        assert (uf, p, ce) == (uf_p, p_p, ce_p), (name, uf, p, ce)


def test_balance_stages_optimal_bottleneck():
    costs = [5, 1, 1, 1, 5, 1, 1, 1]
    bounds = tp.balance_stages(costs, 4)
    stage_costs = [sum(costs[bounds[i]:bounds[i + 1]]) for i in range(4)]
    assert max(stage_costs) == 5           # optimal: [5][1,1,1][5][1,1,1]
    assert bounds[0] == 0 and bounds[-1] == len(costs)
    assert all(b2 > b1 for b1, b2 in zip(bounds, bounds[1:]))


def test_balance_stages_monotone_in_stage_count():
    costs = [3.0, 7.0, 2.0, 5.0, 4.0, 6.0, 1.0, 8.0]
    prev = math.inf
    for s in range(1, len(costs) + 1):
        b = tp.balance_stages(costs, s)
        rate = tp.pipeline_throughput(costs, b)
        assert 1.0 / rate <= prev + 1e-9
        prev = 1.0 / rate


# ------------------------------------------------------ equal to the reference
def test_constants_and_table3_equal_reference():
    assert tp.BCNN_CONV_LAYERS == tuple(
        tp.ConvLayerDims(**dataclasses.asdict(d))
        for d in jtp.BCNN_CONV_LAYERS)
    assert tp.BCNN_FC_SPECS == jtp.BCNN_FC_SPECS
    assert tp.PAPER_TABLE3 == jtp.PAPER_TABLE3
    assert (tp.FREQ_HZ, tp.PAPER_FPS, tp.PAPER_TOPS, tp.PAPER_POWER_W) == (
        jtp.FREQ_HZ, jtp.PAPER_FPS, jtp.PAPER_TOPS, jtp.PAPER_POWER_W)
    assert tp.reproduce_table3() == jtp.reproduce_table3()
    assert tp.ops_per_image() == jtp.ops_per_image()
    assert tp.tops(6218.0) == jtp.tops(6218.0)
    for budget in (16, 56, 112, 224):
        assert tp.optimize_parallelism(pe_budget=budget) == \
            jtp.optimize_parallelism(pe_budget=budget)


@pytest.mark.parametrize("seed", range(6))
def test_balance_stages_equals_reference_on_random_costs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    costs = [float(c) for c in rng.uniform(0.1, 10.0, n)]
    if seed % 2:                 # integer costs: ties between cuts
        costs = [float(int(c)) + 1.0 for c in costs]
    for s in range(1, n + 1):
        b = tp.balance_stages(costs, s)
        assert b == jtp.balance_stages(costs, s), (costs, s)
        assert tp.pipeline_throughput(costs, b, 90e6) == \
            jtp.pipeline_throughput(costs, b, 90e6)
        assert pp.stage_costs_from_bounds(costs, b) == \
            jpp.stage_costs_from_bounds(costs, b)
    for m in (1, 3, 64):
        for mult in (1.0, 3.0):
            assert pp.schedule_1f1b(costs, m, fwd_bwd_mult=mult) == \
                jpp.schedule_1f1b(costs, m, fwd_bwd_mult=mult)
    if n >= 3:
        assert pp.elastic_stage_plan(costs, 2, 3) == \
            jpp.elastic_stage_plan(costs, 2, 3)


# ------------------------------------- tests/test_pipeline.py's analytic cases
def test_plan_stages_balanced():
    cfg = configs.get_config("yi-6b")
    bounds = pp.plan_stages(cfg, 4)
    assert bounds[0] == 0 and bounds[-1] == cfg.n_layers
    sizes = np.diff(bounds)
    assert sizes.min() >= 1
    # uniform layers → perfectly even split
    assert sizes.max() - sizes.min() <= 1


def test_schedule_1f1b_limits():
    s = pp.schedule_1f1b([1.0, 1.0, 1.0, 1.0], n_micro=4)
    assert 0 < s["bubble_fraction"] < 1
    big = pp.schedule_1f1b([1.0] * 4, n_micro=4096)
    assert big["bubble_fraction"] < 0.01          # eq.12 limit: no bubble
    assert abs(big["efficiency"] - 1.0) < 0.01


def test_moe_stage_costs_higher():
    """The reference's MoE case on the port's own deepseek-v2-lite-16b."""
    j = jconfigs.get_config("deepseek-v2-lite-16b")
    cfg = configs.get_config("deepseek-v2-lite-16b")
    assert isinstance(cfg, base.ModelConfig)
    costs = pp.layer_costs(cfg, 4096)
    assert len(costs) == cfg.n_layers and min(costs) > 0
    assert costs == jpp.layer_costs(j, 4096)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_lm_stage_plans_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for seq in (1, 4096):
        assert pp.layer_costs(cfg, seq) == jpp.layer_costs(jcfg, seq)
    for s in (1, 2, 4, 8):
        assert pp.plan_stages(cfg, s) == jpp.plan_stages(jcfg, s)
