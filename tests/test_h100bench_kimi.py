"""The benchmark's additions for Kimi Linear, on the CPU (no card; the
port's plain path at small sizes): the new configuration, cell and
metrics found by name, the reference's imports, a program without the
architecture failing before any weight, the seeded tree in the port's
layout, the work count, the readers of the ``kda.*`` spans, and the cell
driven to a correct result with its control failing."""
import ast
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from h100bench import harness  # noqa: E402
from h100bench.drivers import kimi_prefill_stream as kimi  # noqa: E402
from h100bench.work import kimi_linear as work  # noqa: E402

SEED = 3 * 2 ** 31 + 7
KIMI = "kimilinear.prefill_long"
KDA_METRICS = ("kda_device_ms_per_ktok.kimi_long",
               "kda_scan_device_ms_per_ktok.kimi_long")
SHARED_METRICS = ("moe_glue_device_ms_per_ktok.kimi_long",
                  "moe_experts_device_ms_per_ktok.kimi_long",
                  "moe_drop_pct.kimi_long",
                  "mla_device_ms_per_ktok.kimi_long",
                  "k7_roofline.kimi_long", "device_idle.kimi_long")


def test_the_new_configuration_cell_and_metrics_are_declared():
    bench = harness.spec()
    cfg = {c["name"]: c for c in bench["configs"]}["kimi-linear-48b-a3b"]
    assert cfg["reduced"] == ["num_experts"]
    file = harness.config("kimi-linear-48b-a3b")
    assert (file["num_experts"], file["published"]["num_experts"],
            file["expert_share"]) == (128, 256, [0, 128])
    wl = harness.workload(KIMI)
    assert wl["config"] == "kimi-linear-48b-a3b" and wl["chips"] == 1
    assert (harness.HERE / "drivers" / f"{wl['driver']}.py").is_file()
    ends, _ = harness.cell_metrics(bench, KIMI)
    assert {m["name"] for m in ends} == {"prefill_tokens_per_s", "setup_s"}
    _, layer = harness.cell_metrics(bench, KIMI)
    assert {m["name"] for m in layer} == {*KDA_METRICS, *SHARED_METRICS,
                                          "mfu.kimi_long"}
    for m in layer:
        assert m["moves"] == "prefill_tokens_per_s"
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_the_kimi_reference_imports_nothing_of_the_program():
    path = harness.HERE / "reference" / "kimi_linear_plain.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch"}


def test_the_configuration_file_resolves_to_the_published_widths():
    mcfg = kimi.port_config(harness.config("kimi-linear-48b-a3b"))
    assert (mcfg.n_layers, mcfg.d_model, mcfg.n_experts, mcfg.expert_share,
            mcfg.top_k, mcfg.kda_heads, mcfg.kda_head_dim, mcfg.mla_nope,
            mcfg.router, mcfg.routed_scale, mcfg.dtype) == \
        (27, 2304, 256, (0, 128), 8, 32, 128, True, "sigmoid", 2.446,
         "bfloat16")
    assert len(mcfg.kda_layers) == 20


def test_a_program_without_the_architecture_fails_before_any_weight(
        monkeypatch):
    from repro_torch import configs
    monkeypatch.setattr(configs, "PORT_ONLY_MODULES", {})

    def no_weights(*a, **k):
        raise AssertionError("weights drawn")
    monkeypatch.setattr(kimi, "kimi_params", no_weights)
    run = harness.new_run(KIMI, SEED, 1.0, False, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        kimi.setup(run)


def smoke_tree():
    from repro_torch.models import transformer
    mcfg = kimi.port_config(harness.config("kimi-linear-48b-a3b"),
                            smoke=True)
    return mcfg, kimi.file_sizes(mcfg), transformer


def test_the_seeded_tree_has_the_ports_layout():
    mcfg, sizes, transformer = smoke_tree()
    want = transformer.init_params(mcfg, torch.Generator().manual_seed(0))
    got = kimi.kimi_params(sizes, SEED, "cpu")

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v for k, v in t.items()
                    for k2, v in flat(v, f"{pre}/{k}").items()}
        return {pre: (tuple(t.shape), t.dtype)}
    assert flat(got) == flat(want)


def test_the_work_count_is_the_trees_parameters_a_token_uses():
    """2 x the parameters of the seeded tree a token multiplies: every
    weight of a layer (norm scales, A_log and dt_bias left out), the held
    experts at k / all experts each."""
    _, sizes, _ = smoke_tree()
    tree = kimi.kimi_params(sizes, SEED, "cpu")
    k, e = sizes["num_experts_per_token"], sizes["num_experts"]
    total = 0.0
    for key, stack in tree.items():
        if not key.startswith("stack"):
            continue

        def count(t, path=()):
            if isinstance(t, dict):
                return sum(count(v, path + (n,)) for n, v in t.items())
            if path[-1] in ("scale", "a_log", "dt_bias", "bias"):
                return 0
            n = t[0].numel()
            return n * k / e if "experts" in path else n
        total += count(stack) * stack["ln1"]["scale"].shape[0]
    assert work.token_params(sizes) == pytest.approx(total)
    s = 100
    f = work.prefill_flops(sizes, 2, s)
    assert f > 2 * total * 2 * s
    assert work.rule_flops_per_token(sizes) == \
        7 * sizes["kda_num_heads"] * sizes["kda_head_dim"] ** 2 * 3


def test_the_kda_readers():
    def span(name, ms):
        return {"name": name, "id": 0, "parent": None, "start_ns": 0,
                "end_ns": 1, "attrs": {}, "device_ms": ms}
    sp = [span("kda.proj", 1.0), span("kda.scan", 4.0),
          span("kda.out", 1.0), span("mla.attention", 9.0)]
    run = SimpleNamespace(trace=True, record={"program_trace": (sp, {}),
                                              "tokens_in": 2000})
    read = {m: harness.load_module("metrics", m).read for m in KDA_METRICS}
    assert read[KDA_METRICS[0]](run) == pytest.approx(3.0)
    assert read[KDA_METRICS[1]](run) == pytest.approx(2.0)
    empty = SimpleNamespace(trace=True, record={"program_trace": ([], {}),
                                                "tokens_in": 2000})
    assert all(r(empty) is None for r in read.values())


def test_the_moe_and_k7_readers_of_the_share():
    """The drop rate is over the held pairs, not all pairs; K7's bound
    counts the MLA layers alone."""
    def span(name, ms):
        return {"name": name, "id": 0, "parent": None, "start_ns": 0,
                "end_ns": 1, "attrs": {}, "device_ms": ms}
    sp = [span("moe.route", 1.0), span("moe.dispatch", 2.0),
          span("moe.combine", 3.0), span("moe.experts", 4.0),
          span("mla.attention", 5.0), span("kda.scan", 9.0)]
    counters = {"moe.pairs": 800, "moe.pairs_held": 400,
                "moe.pairs_dropped": 100}
    run = SimpleNamespace(trace=True, record={
        "program_trace": (sp, counters), "tokens_in": 2000})
    read = {m: harness.load_module("metrics", m).read
            for m in SHARED_METRICS}
    assert read["moe_glue_device_ms_per_ktok.kimi_long"](run) == \
        pytest.approx(3.0)
    assert read["moe_experts_device_ms_per_ktok.kimi_long"](run) == \
        pytest.approx(2.0)
    assert read["mla_device_ms_per_ktok.kimi_long"](run) == \
        pytest.approx(2.5)
    assert read["moe_drop_pct.kimi_long"](run) == pytest.approx(25.0)
    # a program without the held-pairs counter reads nothing
    counters.pop("moe.pairs_held")
    assert read["moe_drop_pct.kimi_long"](run) is None
    _, sizes, _ = smoke_tree()
    from h100bench.work import attention
    mla_layers = sizes["num_hidden_layers"] - len(sizes["kda_layers"])
    d_qk = sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"]
    assert work.attention_bound_s(sizes, 4, 256) == pytest.approx(
        mla_layers * attention.bound_s(4, sizes["num_attention_heads"], 256,
                                       d_qk, sizes["v_head_dim"]))


def small_run(lengths=(40, 24, 70)):
    run = harness.new_run(KIMI, SEED, 0.01, False, device="cpu")
    run.smoke = True
    run.workload["params"].update(lengths=list(lengths), pool_rows=8,
                                  batch=4)
    return run


def test_the_kimi_cell_is_correct_on_the_cpu_and_its_control_is_not():
    """A window of one call (so the same rows are checked on every host),
    against the cell's own limits: the control fails the branch number
    by more than 3x its limit's distance from the program's reading."""
    run = small_run()
    line = harness.measure(run, time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    limits = run.params["limits"]
    st = kimi.setup(run)
    ctrl = kimi.check(run, st, run.record, control=True)
    assert ctrl["logit_rel_err_median"] > limits["logit_rel_err_median"]
    assert ctrl["branch_rel_err_max"] > limits["branch_rel_err_max"]
    assert ctrl["branch_rel_err_max"] > \
        3 * line["checks"]["branch_rel_err_max"]["value"]


@pytest.mark.parametrize("fault", ["beta", "routed_scale", "mla_rope"])
def test_the_branch_check_catches_a_planted_fault(fault, monkeypatch):
    """A tenth off the KDA's beta or the gates' routed scale, or MLA's
    64-wide part rotated: the branch number passes its limit; the sound
    program stays under it."""
    from repro_torch.models import kda
    from h100bench.reference import kimi_linear_plain as reference
    run = small_run((64,))
    st = kimi.setup(run)
    toks = st.pool[:4, :64]
    limit = run.params["limits"]["branch_rel_err_max"]
    sound = max(reference.branch_gaps(st.sizes, st.params, toks,
                                      kimi.program_branch(st)))
    assert sound < limit
    if fault == "beta":
        inputs = kda._inputs

        def off(*a, **k):
            got, tail = inputs(*a, **k)
            return got[:4] + [got[4] * 0.9], tail
        monkeypatch.setattr(kda, "_inputs", off)
    elif fault == "routed_scale":
        st.mcfg = st.mcfg.with_(routed_scale=st.mcfg.routed_scale * 0.9)
    else:
        st.mcfg = st.mcfg.with_(mla_nope=False)
    faulty = max(reference.branch_gaps(st.sizes, st.params, toks,
                                       kimi.program_branch(st)))
    assert faulty > limit
