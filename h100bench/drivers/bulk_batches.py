"""Offline classification of a stored dataset: back-to-back
``BCNNEngine.classify_batch`` calls of one batch of the seed's N images
through the engine's bulk route (``from_packed(data_shards=...,
data_micro_batch=...)``, ``parallel/bcnn_data_parallel.py``), closed loop,
one caller. The window runs until the first batch whose logits are back on
the host at or after ``--seconds``; the rate is the window's images over
its length, so no batch is cut in two."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np

from h100bench import programs
from h100bench.drivers import bcnn_common


@dataclass
class State:
    engine: object
    latent: dict
    imgs: object
    host: np.ndarray


def setup(run) -> State:
    p = run.params
    latent, imgs, host = bcnn_common.inputs(run)
    packed = programs.bcnn_packed(latent)
    eng = programs.bcnn_engine(packed, run.device,
                               data_shards=p["data_shards"],
                               data_micro_batch=p["data_micro_batch"])
    eng.classify_batch(host)          # captures the bulk route's graph
    eng.classify_batch(host)
    return State(eng, latent, imgs, host)


def drive(run, state: State) -> dict:
    p = run.params
    eng, host = state.engine, state.host
    tracer = run.tracer
    clock = time.perf_counter
    outs, calls = [], []           # (host seconds, in the slice)
    attempted = 0
    t0 = clock()
    while True:
        tracer.tick(clock() - t0)
        attempted += 1
        ts = clock()
        out = eng.classify_batch(host)
        te = clock()
        outs.append(out)
        calls.append((te - ts, tracer.active))
        if te - t0 >= run.seconds:
            window = te - t0
            break
    tracer.stop()
    images = sum(len(o) for o in outs)
    c = np.array(calls, dtype=np.float64).reshape(-1, 2)
    out_ = c[:, 1] == 0
    n = len(host)
    return {
        "e2e": {"images_per_s": images / window},
        "attempted": attempted, "failed": 0, "outs": outs,
        "batches_in": int((~out_).sum()),
        "images_out": int(out_.sum()) * n,
        "time_out": window - run.tracer.taken_s,
        "chunk": p["data_shards"] * p["data_micro_batch"],
        "batch": n,
    }


def check(run, state: State, record: dict, control: bool = False) -> dict:
    """Every batch's logits against the plain reference's, bit for bit;
    rows a batch did not return are missing."""
    want = bcnn_common.reference_logits(state.latent, state.imgs)
    if control:
        got = bcnn_common.reference_logits(state.latent, state.imgs,
                                           control=True)
        outs = [got] * len(record["outs"])
    else:
        outs = record["outs"]
    wrong = missing = 0
    for out in outs:
        rows = min(len(out), len(want))
        missing += len(want) - rows
        w = bcnn_common.wrong_rows(out[:rows], want[:rows])
        if w and not control and not wrong:
            print("h100bench: " + bcnn_common.explain(
                state.latent, state.imgs, out[:rows], want[:rows],
                np.arange(rows)), file=sys.stderr)
        wrong += w
    return {"wrong_answers": wrong, "missing_answers": missing}
