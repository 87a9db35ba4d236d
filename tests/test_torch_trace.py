"""The port's spans and counters (``repro_torch/trace.py``) on the CPU: off
by default and then recording nothing, on after ``enable()`` or inside an
active ``torch.profiler`` session, spans nested per thread with their
profiler twins, and the instrumented engine step and MoE layer: their
counts match what the scheduler admitted and what the dispatch dropped,
and their outputs are bitwise those of an untraced run."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, trace
from repro_torch.core import bcnn
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import mla, moe
from repro_torch.serve.bcnn_engine import BCNNEngine

ENGINE_SPANS = ("engine.step", "engine.admit", "engine.launch",
                "engine.wait", "engine.complete")
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def clean_trace():
    """Every test starts and ends with recording off and nothing held."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def packed():
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))


@pytest.fixture(scope="module")
def images():
    x, _ = SyntheticImages(global_batch=7, seed=3).batch(0)
    return x


def moe_layer(seed: int = 0):
    cfg = configs.get_config("deepseek-v2-lite-16b", smoke=True).with_(
        dtype="float32")
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg,
                     torch.float32)
    return cfg, p


def by_id(spans):
    return {s["id"]: s for s in spans}


# ----------------------------------------------------------------- module

def test_off_records_nothing():
    assert not trace.on()
    sp = trace.span("a", device=True, k=1)
    assert sp is trace.NOOP
    with trace.span("b") as inner:
        inner.set(x=2)
    trace.count("c", 3)
    trace.count("d", torch.tensor(4))
    assert trace.drain() == ([], {})


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_nest_with_their_parents(how):
    def body():
        with trace.span("outer", step=7) as o:
            with trace.span("first"):
                with trace.span("deep"):
                    pass
            with trace.span("second"):
                pass
            o.set(last=9)
        trace.count("n", 2)
        trace.count("n", 3)
        trace.count("t", torch.tensor(5))
        trace.count("t", torch.tensor(6))

    if how == "enable":
        trace.enable()
        body()
        trace.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert trace.on()
            body()
        assert not trace.on()
        with trace.span("after"):       # the session has ended
            pass
    spans, counters = trace.drain()
    assert [s["name"] for s in spans] == ["deep", "first", "second",
                                          "outer"]
    ids = by_id(spans)
    parent = {s["name"]: ids[s["parent"]]["name"] if s["parent"] is not None
              else None for s in spans}
    assert parent == {"outer": None, "first": "outer", "deep": "first",
                      "second": "outer"}
    outer = spans[-1]
    assert outer["attrs"] == {"step": 7, "last": 9}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]
    assert counters == {"n": 5, "t": 11}
    assert trace.drain() == ([], {})


def test_each_thread_has_its_own_stack():
    trace.enable()
    barrier = threading.Barrier(2, timeout=30)

    def worker(name):
        with trace.span(name):
            barrier.wait()          # both outer spans open at once
            with trace.span(name + ".child"):
                pass
            barrier.wait()

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans, _ = trace.drain()
    ids = by_id(spans)
    for s in spans:
        if s["name"].endswith(".child"):
            assert ids[s["parent"]]["name"] == s["name"][0]
        else:
            assert s["parent"] is None


def test_bounded_buffer_counts_spans_lost(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            pass
    spans, counters = trace.drain()
    assert len(spans) == 3 and counters == {"trace.spans_lost": 2}


def test_reset_drops_everything():
    trace.enable()
    with trace.span("s"):
        trace.count("c", 1)
    trace.reset()
    assert trace.drain() == ([], {})


def test_span_starts_lie_by_their_profiler_twins(packed, images):
    eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for img in images:
            eng.submit(img)
        eng.run()
    spans, _ = trace.drain()
    twins: dict[str, list[int]] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ENGINE_SPANS:
            # a host range only: a user annotation would also lay a range
            # over the device timeline, counted as device work there
            assert not ev.is_user_annotation()
            twins.setdefault(ev.name(), []).append(ev.start_ns())
    names = [s["name"] for s in spans]
    assert sorted(names) == sorted(n for n, v in twins.items() for _ in v)
    assert set(names) == set(ENGINE_SPANS)
    for s in spans:
        gap = min(abs(t - s["start_ns"]) for t in twins[s["name"]])
        assert gap < 1_000_000, (s["name"], gap)


# ------------------------------------------------------------- the engine

def test_engine_steps_tie_to_the_schedulers_admissions(packed, images,
                                                      monkeypatch):
    eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
    admissions = []             # the rids of each admit() call
    admit = eng.sched.admit

    def recorded():
        got = admit()
        admissions.append([r.rid for _, r in got])
        return got
    monkeypatch.setattr(eng.sched, "admit", recorded)
    trace.enable()
    # 3, then 7 more at once: steps admitting 3, 4 and 3
    for img in images[:3]:
        eng.submit(img)
    eng.step()
    for img in images:
        eng.submit(img)
    eng.run()
    trace.disable()
    spans, counters = trace.drain()
    steps = [s for s in spans if s["name"] == "engine.step"]
    assert [s["attrs"]["step"] for s in steps] == [0, 1, 2]
    assert [len(a) for a in admissions] == [3, 4, 3]
    for s, rids in zip(steps, admissions):
        lo, hi = s["attrs"]["first_rid"], s["attrs"]["last_rid"]
        assert rids == list(range(lo, hi + 1))
    assert counters == {"engine.steps": 3, "engine.slots_occupied":
                        sum(len(a) for a in admissions)}
    ids = by_id(spans)
    for s in spans:
        if s["name"] != "engine.step":
            assert ids[s["parent"]]["name"] == "engine.step"
    assert sorted(s["name"] for s in spans) == sorted(ENGINE_SPANS * 3)


def test_engine_slots_occupied_sums_each_steps_occupancy(packed, images):
    """A step that admits nothing but still holds requests counts them:
    ``engine.slots_occupied`` sums the occupied slots of every forward."""
    eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
    trace.enable()
    for img in images[:2]:
        eng.submit(img)
    eng.sched.admit()               # admitted outside any step
    eng._flush()
    trace.disable()
    spans, counters = trace.drain()
    assert counters == {"engine.steps": 1, "engine.slots_occupied": 2}
    assert [s["name"] for s in spans] == ["engine.launch", "engine.wait",
                                          "engine.complete"]


def test_engine_step_off_reads_the_flag_once(packed, images, monkeypatch):
    """Off, a step reads ``trace.on()`` once and neither opens a span nor
    counts."""
    eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
    reads = []
    monkeypatch.setattr(trace, "on", lambda: reads.append(1) or False)

    def refuse(*args, **kwargs):
        raise AssertionError("traced while off")
    monkeypatch.setattr(trace, "span", refuse)
    monkeypatch.setattr(trace, "count", refuse)
    for img in images[:3]:
        eng.submit(img)
    assert len(eng.step()) == 3
    assert len(reads) == 1


def test_engine_logits_equal_with_tracing_on_and_off(packed, images):
    outs = []
    for on in (False, True):
        eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
        if on:
            trace.enable()
        rids = [eng.submit(img) for img in images]
        got = eng.run()
        trace.disable()
        outs.append(np.stack([got[r] for r in rids]))
    assert np.array_equal(outs[0], outs[1])
    assert trace.drain()[0]


# --------------------------------------------------------------- the MoE

def plain_drops(p, cfg, x) -> int:
    """Pairs whose rank within their expert reaches the capacity, from the
    router's choices and ``dispatch`` alone."""
    _, _, expert_idx = moe.route(p, cfg, x)
    cap = moe.capacity(x.shape[1], cfg.n_experts, cfg.top_k)
    ok = moe.dispatch(expert_idx, cap)[3]
    return int((~ok).sum())


@pytest.mark.parametrize("overflow", [False, True])
def test_moe_counts_the_pairs_dropped_at_capacity(overflow):
    cfg, p = moe_layer()
    b, s = 2, 48
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    if overflow:
        # every token picks the same top-k experts: each of them receives
        # s pairs a row, past its capacity
        w = torch.zeros_like(p["router"]["w"])
        w[:, : cfg.top_k] = 1e-3 * torch.arange(cfg.top_k, 0, -1,
                                                dtype=torch.float32)
        p = {**p, "router": {"w": w}}
        x = x.abs() + 1.0
    want = plain_drops(p, cfg, x)
    trace.enable()
    moe.moe_apply(p, cfg, x)
    trace.disable()
    spans, counters = trace.drain()
    assert counters == {"moe.pairs": b * s * cfg.top_k,
                        "moe.pairs_held": b * s * cfg.top_k,
                        "moe.pairs_dropped": want}
    cap = moe.capacity(s, cfg.n_experts, cfg.top_k)
    if overflow:
        assert want == b * cfg.top_k * (s - cap) > 0
    assert [sp["name"] for sp in spans] == [*MOE_SPANS, "moe.experts"]
    assert all(sp["parent"] is None and sp["device_ms"] is None
               for sp in spans)


def test_moe_output_equal_with_tracing_on_and_off():
    cfg, p = moe_layer(1)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    y0, aux0 = moe.moe_apply(p, cfg, x)
    trace.enable()
    y1, aux1 = moe.moe_apply(p, cfg, x)
    trace.disable()
    assert torch.equal(y0, y1) and torch.equal(aux0, aux1)
    assert trace.drain()[1]["moe.pairs"] == 2 * 24 * cfg.top_k


def test_mla_forward_is_one_span():
    cfg = configs.get_config("deepseek-v2-lite-16b", smoke=True).with_(
        dtype="float32")
    p = mla.mla_init(torch.Generator().manual_seed(2), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32))
    pos = torch.arange(12)[None]
    with torch.no_grad():
        y0 = mla.mla_forward(p, cfg, x, pos)
        trace.enable()
        y1 = mla.mla_forward(p, cfg, x, pos)
        trace.disable()
    assert torch.equal(y0, y1)
    spans, counters = trace.drain()
    assert [s["name"] for s in spans] == ["mla.attention"] and not counters
