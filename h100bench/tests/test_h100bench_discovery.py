"""The harness is driven by data: a workload file dropped into a copy of
the benchmark is found by its name, with no edit to any file there."""
import importlib.util
import json
import shutil
import sys
import time

HERE_NAME = "h100bench"


def copy_harness(tmp_path):
    from h100bench import harness
    dst = tmp_path / HERE_NAME
    shutil.copytree(harness.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = importlib.util.spec_from_file_location("copied_harness",
                                                  dst / "harness.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["copied_harness"] = mod
    spec.loader.exec_module(mod)
    return mod, dst


def test_a_new_workload_file_is_found_by_name(tmp_path):
    h, dst = copy_harness(tmp_path)
    wl = json.loads((dst / "workloads" / "bcnn.online64.json").read_text())
    wl["name"] = "bcnn.online4"
    wl["params"].update(n_slots=4, rate_hz=20.0, images=8)
    (dst / "workloads" / "bcnn.online4.json").write_text(json.dumps(wl))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bcnn.online4", "config":
                               "bcnn-cifar10", "traffic": "online4",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bcnn.online64" in m.get("workloads", []):
            m["workloads"].append("bcnn.online4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert h.workload("bcnn.online4")["params"]["n_slots"] == 4
    e2e, layer = h.cell_metrics(h.spec(), "bcnn.online4")
    assert {m["name"] for m in e2e} == {"image_latency_p95_ms", "setup_s"}
    assert "engine_step_ms.online" in {m["name"] for m in layer}
    run = h.new_run("bcnn.online4", 12345678901, 1.0, False, device="cpu")
    line = h.measure(run, time.perf_counter())
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"image_latency_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_every_named_file_exists():
    from h100bench import harness
    bench = harness.spec()
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert (harness.HERE / "drivers" / f"{wl['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
