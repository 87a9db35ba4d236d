"""The benchmark's readers of the program's own spans and counters
(``h100bench/spans.py`` and the twelve ``h100bench/metrics/`` files that
use it), fed a synthetic slice: the idle overlap, the per-1k-token sums,
the shares of two counters, and None where the slice holds nothing to
read or the program has no tracer."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from h100bench import harness, spans  # noqa: E402
from repro_torch import trace  # noqa: E402

ONLINE = ("engine_admit_ms.online", "engine_wait_ms.online",
          "slot_fill_pct.online", "idle_in_engine_pct.online")
PREFILL = tuple(f"{m}.{c}" for c in ("long", "batch")
                for m in ("mla_device_ms_per_ktok",
                          "moe_glue_device_ms_per_ktok",
                          "moe_experts_device_ms_per_ktok", "moe_drop_pct"))
# kernels at [0, 100), [300, 400), [1000, 1100), [1500, 1600) ns: gaps
# [100, 300), [400, 1000), [1100, 1500), 1200 ns in all
KERNELS = [("k", 0, 100), ("k", 300, 100), ("k", 1000, 100),
           ("k", 1500, 100)]


def span(name, start, end, device_ms=None, i=0):
    return {"name": name, "id": i, "parent": None, "start_ns": start,
            "end_ns": end, "attrs": {}, "device_ms": device_ms}


def make_run(spans_, counters, kernels=KERNELS, **record):
    summary = {"kernels": list(kernels), "busy_s": 0.0, "window_s": 1.0}
    rec = dict(record, program_trace=(spans_, counters))
    return SimpleNamespace(trace=True, record=rec,
                           tracer=SimpleNamespace(summary=summary))


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_every_new_metric_is_declared_with_its_cell():
    bench = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in ONLINE + PREFILL:
        m = bench[name]
        cell = ("bcnn.online64" if name.endswith(".online") else
                "dsv2lite.prefill_" + name.rsplit(".", 1)[1])
        assert m["workloads"] == [cell]
        assert m["source"] in ("program_span", "program_counter")


def test_engine_host_ms_a_step():
    sp = [span("engine.step", 0, 2_000_000), span("engine.step",
                                                   3_000_000, 5_000_000),
          span("engine.admit", 0, 200_000),
          span("engine.admit", 3_000_000, 3_400_000),
          span("engine.wait", 500_000, 1_500_000),
          span("engine.wait", 3_500_000, 4_000_000)]
    run = make_run(sp, {})
    assert read("engine_admit_ms.online", run) == pytest.approx(0.3)
    assert read("engine_wait_ms.online", run) == pytest.approx(0.75)


def test_slot_fill_share():
    run = make_run([], {"engine.steps": 4, "engine.slots_occupied": 64},
                   forward_batch=64)
    assert read("slot_fill_pct.online", run) == pytest.approx(25.0)


@pytest.mark.parametrize("extra, inside_ns", [
    ([], 400), ([span("engine.step", 60, 340)], 400),
    ([span("engine.step", 340, 950)], 900)])
def test_idle_inside_the_engine(extra, inside_ns):
    """Inside [50, 350) and [900, 1200): 200 + 100 + 100 of the 1200 ns of
    gaps; a span nested in another counts once, and one that joins the
    two adds the gap between them."""
    sp = [span("engine.step", 50, 350), span("engine.step", 900, 1200),
          *extra]
    run = make_run(sp, {})
    assert read("idle_in_engine_pct.online", run) == pytest.approx(
        100 * inside_ns / 1200)


def test_idle_inside_one_span():
    run = make_run([span("engine.step", 50, 350)], {})
    assert read("idle_in_engine_pct.online", run) == pytest.approx(
        100 * 200 / 1200)


def test_covered_ns_matches_a_count_of_each_ns():
    rng = np.random.default_rng(0)
    edges = np.sort(rng.choice(400, size=12, replace=False))
    starts, ends = edges[0::2], edges[1::2]
    t = np.arange(-5, 410)
    cover = np.zeros(420, dtype=np.int64)
    for a, b in zip(starts, ends):
        cover[a:b] = 1
    want = np.array([cover[:max(x, 0)].sum() for x in t])
    assert np.array_equal(spans.covered_ns(starts, ends, t), want)


@pytest.mark.parametrize("cell", ["long", "batch"])
def test_device_ms_per_ktok_and_drops(cell):
    sp = [span("mla.attention", 0, 1, 2.0), span("mla.attention", 2, 3, 3.0),
          span("moe.route", 0, 1, 0.5), span("moe.dispatch", 1, 2, 0.25),
          span("moe.combine", 2, 3, 0.75), span("moe.experts", 3, 4, 1.5),
          span("moe.experts", 4, 5, 2.5),
          span("moe.route", 5, 6, None)]        # no device marks: left out
    run = make_run(sp, {"moe.pairs": 1000, "moe.pairs_dropped": 25},
                   tokens_in=2000)
    assert read(f"mla_device_ms_per_ktok.{cell}", run) == pytest.approx(2.5)
    assert read(f"moe_glue_device_ms_per_ktok.{cell}",
                run) == pytest.approx(0.75)
    assert read(f"moe_experts_device_ms_per_ktok.{cell}",
                run) == pytest.approx(2.0)
    assert read(f"moe_drop_pct.{cell}", run) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ONLINE + PREFILL)
def test_none_on_an_empty_slice(name):
    run = make_run([], {}, forward_batch=64, tokens_in=4096)
    assert read(name, run) is None
    untraced = make_run([span("engine.step", 0, 1)], {"moe.pairs": 1},
                        forward_batch=64, tokens_in=4096)
    untraced.trace = False
    del untraced.record["program_trace"]
    assert read(name, untraced) is None


def test_the_programs_trace_is_drained_once():
    trace.reset()
    trace.enable()
    try:
        with trace.span("engine.step"):
            with trace.span("engine.admit"):
                pass
        trace.count("engine.steps", 1)
        trace.count("engine.slots_occupied", 16)
    finally:
        trace.disable()
    run = make_run([], {}, forward_batch=64)
    del run.record["program_trace"]
    assert read("slot_fill_pct.online", run) == pytest.approx(25.0)
    assert read("engine_admit_ms.online", run) is not None
    assert trace.drain() == ([], {})
    assert len(run.record["program_trace"][0]) == 2


def test_a_program_without_a_tracer_reads_as_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    run = make_run([], {}, forward_batch=64, tokens_in=10)
    del run.record["program_trace"]
    for name in ONLINE + PREFILL:
        assert read(name, run) is None
