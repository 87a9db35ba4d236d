"""The benchmark's core: find a cell's files by name, set the program up,
drive the timed window, check what the timed path produced, and print the
one result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

    workloads/<cell>.json    configuration, chips, driver, its parameters,
                             the limits of the correctness check, why
    configs/<config>.json    the configuration as it is run
    drivers/<driver>.py      one traffic kind: setup, drive, check
    metrics/<metric>.py      one per-layer reader: read(run) -> value | None

A driver module has ``setup(run) -> state``, ``drive(run, state) ->
record`` (the timed window; ``record["e2e"]`` holds the cell's end-to-end
values), and ``check(run, state, record, control=False) -> {name: value}``
(the numbers compared with the plain reference; with ``control`` the
control's numbers instead), called once the window has closed and the
peak memory has been read.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules the timed process must not hold once the window has closed,
# compared by whole top-level name ("repro_torch" is the port, "repro" the
# JAX package)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(HERE / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by file path (a
    metric's name holds dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"h100bench_{kind}_" + name.replace(".", "_").replace("-",
                                                                      "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    if spec_ is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[mod_name] = mod
    spec_.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports: those that list it, or list no cells (a per-layer
    metric without a list goes with every cell of the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


@dataclass
class Run:
    """One run of one cell: what it was given, and what it measured."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    workload: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    tracer: object = None
    record: dict = field(default_factory=dict)
    smoke: bool = False     # the port's small preset of the configuration
                            # (CPU tests only)

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def slice_window(self) -> tuple[float, float]:
        """(start, length) in seconds of the traced slice: a steady part in
        the second half of the window."""
        return self.seconds / 2, min(4.0, self.seconds / 4)


def new_run(cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> Run:
    from h100bench.trace import Tracer
    wl = workload(cell)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, workload=wl,
              config=config(wl["config"]))
    start, length = run.slice_window()
    run.tracer = Tracer(run.trace, start, length)
    return run


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & FORBIDDEN)


def device_info(run: Run, peak_bytes: int) -> dict:
    import torch
    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def measure(run: Run, t_start: float, driver=None) -> dict:
    """Set up, drive, read the peak memory, check, and build the result
    line (a dict whose key ``checks`` comes last)."""
    import torch
    driver = driver or load_module("drivers", run.workload["driver"])
    state = driver.setup(run)
    run.tracer.warm()
    setup_s = time.perf_counter() - t_start
    cuda = run.device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    record = driver.drive(run, state)
    run.tracer.stop()
    run.tracer.finish()
    run.record = record
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = driver.check(run, state, record)
    limits = run.params["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    del state
    gc.collect()

    bench = spec()
    e2e, layer = cell_metrics(bench, run.cell)
    metrics = {}
    if run.trace:
        for m in layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(record["e2e"], setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = device_info(run, peak)
    line = {"correct": correct, "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics,
            "device": device}
    summary = run.tracer.summary
    if run.trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
