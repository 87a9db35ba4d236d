"""Online image classification: an open loop of independent single-image
requests with Poisson arrivals at a fixed rate, through one
``BCNNEngine`` (``serve/bcnn_engine.py``) whose slots the benchmark fills
with ``submit`` and steps with ``step``; each step replays the forward's
captured graph.

Arrivals (the process of ``serve/bcnn_engine.py::drive_poisson``, made
steady across seeds): the n = rate x seconds exponential gaps are the
distribution's n midpoint quantiles, in an order the seed draws, so every
seed offers the same gaps and the same count in another order. Image i is
image i mod N of the seed's N. Each request is timed from the moment it
was due to the moment its logits are back on the host, by the same clock
the engine stamps admission with (``time.perf_counter``)."""
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


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s, from the window's start) of the requests due inside
    ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(seed).shuffle(gaps)
    due = np.cumsum(gaps)
    return due[due < seconds]


def setup(run) -> State:
    p = run.params
    latent, imgs, host = bcnn_common.inputs(run)
    packed = programs.bcnn_packed(latent)
    eng = programs.bcnn_engine(packed, run.device, n_slots=p["n_slots"])
    eng.warmup()
    # one full step of real submits: the step's host path, warm
    for i in range(p["n_slots"]):
        eng.submit(host[i])
    eng.run()
    return State(eng, latent, imgs, host)


def drive(run, state: State, rate: float | None = None) -> dict:
    """The window: submit each request when due, step while anything is
    live, then keep stepping until every request due in the window is
    answered (at most ``patience_s`` past the close)."""
    p = run.params
    eng, host = state.engine, state.host
    sched = eng.sched
    due = arrivals(rate or p["rate_hz"], run.seconds, run.seed)
    n, n_img = len(due), len(host)
    done = np.full(n, np.nan)
    admit = np.full(n, np.nan)
    logits = np.zeros((n, p["n_classes"]), dtype=np.float32)
    steps = []           # (host seconds, images, in the slice, end time)
    tracer = run.tracer
    clock = time.perf_counter
    rid0 = None
    nxt = 0
    backlog_at_close = None
    t0 = clock()
    while True:
        now = clock() - t0
        tracer.tick(now)
        while nxt < n and due[nxt] <= now:
            rid = eng.submit(host[nxt % n_img])
            if rid0 is None:
                rid0 = rid
            nxt += 1
        if backlog_at_close is None and now >= run.seconds:
            backlog_at_close = sched.n_queued + sched.n_occupied
        if sched.any_active:
            ts = clock()
            res = eng.step()
            te = clock()
            k = len(res)
            steps.append((te - ts, k, tracer.active, te - t0))
            idx = np.fromiter(res.keys(), dtype=np.int64, count=k) - rid0
            logits[idx] = np.stack(list(res.values()))
            done[idx] = te - t0
            fin = sched.finished
            for j in range(1, k + 1):
                r = fin[-j]
                admit[r.rid - rid0] = r.t_admit - t0
        elif nxt < n:
            wait = due[nxt] - (clock() - t0)
            if wait > 1e-3:
                time.sleep(wait - 5e-4)
        else:
            break
        if now > run.seconds + p["patience_s"]:
            break
    tracer.stop()
    answered = ~np.isnan(done)
    # a request never answered counts as late as the wait allowed
    lat = np.where(answered, done - due, run.seconds + p["patience_s"] - due)
    # the host-side numbers come from the part of the window before the
    # traced slice, which the profiler's cost does not reach
    cut = tracer.t0 - t0 if tracer.t0 is not None else np.inf
    st = np.array(steps, dtype=np.float64).reshape(-1, 4)
    st_out = st[st[:, 3] < cut]
    st_in = st[st[:, 2] == 1]
    out = answered & (done < cut)
    wait = admit[out] - due[out]
    return {
        "e2e": {"image_latency_p95_ms": float(np.percentile(lat, 95) * 1e3)},
        "attempted": int(n), "failed": int(n - answered.sum()),
        "logits": logits, "answered": answered, "n_img": n_img,
        "backlog_at_close": int(backlog_at_close or 0),
        "latency_s": lat,
        "steps_out": int(len(st_out)), "step_s_out": float(st_out[:, 0].sum()),
        "images_out": int(st_out[:, 1].sum()),
        "steps_in": int(len(st_in)), "images_in": int(st_in[:, 1].sum()),
        "forward_batch": int(p["n_slots"]),
        "queue_wait_p95_ms": (float(np.percentile(wait, 95) * 1e3)
                              if len(wait) else None),
    }


def check(run, state: State, record: dict, control: bool = False) -> dict:
    """Every answer due in the window against the plain reference's logits
    of its image, bit for bit; answers that never came."""
    ref = bcnn_common.reference_logits(state.latent, state.imgs)
    want = ref[np.arange(record["attempted"]) % record["n_img"]]
    if control:
        got = bcnn_common.reference_logits(state.latent, state.imgs,
                                           control=True)
        got = got[np.arange(record["attempted"]) % record["n_img"]]
        answered = np.ones(record["attempted"], dtype=bool)
    else:
        got, answered = record["logits"], record["answered"]
    wrong = bcnn_common.wrong_rows(got[answered], want[answered])
    if wrong and not control:
        image_of = np.arange(record["attempted"]) % record["n_img"]
        print("h100bench: " + bcnn_common.explain(
            state.latent, state.imgs, got[answered], want[answered],
            image_of[answered]), file=sys.stderr)
    return {"wrong_answers": wrong,
            "missing_answers": int((~answered).sum())}
