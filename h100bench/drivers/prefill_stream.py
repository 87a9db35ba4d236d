"""Prompts answered with their first token: back-to-back
``models/transformer.py::prefill`` calls, closed loop, one caller, each
ending when its last-position logits are back on the host.

Prompt lengths: the workload's list of lengths, cycled in the order the
file gives (long and short interleaved), the same for every seed, so that
every seed sends the same sizes in the same order and only the token ids
and the weights differ. Token ids: uniform over the vocabulary, from a
pool the seed fills on the device; call k takes pool rows k*B .. k*B+B-1
(mod the pool).

The window runs until the first call that completes at or after
``--seconds``; the rate is every prompt token of the window's calls (B x S
a call) over the window's length, so no call is cut in two."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

from h100bench import programs, weights
from h100bench.reference import deepseek_v2_plain
from h100bench.work import deepseek as work


@dataclass
class State:
    mcfg: object
    sizes: dict            # the configuration's sizes under the file's keys
    params: dict
    pool: torch.Tensor
    lengths: list


def schedule(lengths: list, calls: int) -> list:
    return [int(lengths[k % len(lengths)]) for k in range(calls)]


def setup(run) -> State:
    p = run.params
    mcfg = programs.lm_config(run.config, smoke=run.smoke)
    sizes = programs.lm_file_sizes(mcfg)
    params = weights.deepseek_params(sizes, run.seed, run.device,
                                     dtype=getattr(torch, mcfg.dtype))
    lengths = p["lengths"]
    pool = weights.token_pool(run.seed, p["pool_rows"], max(lengths),
                              sizes["vocab_size"], run.device)
    st = State(mcfg, sizes, params, pool, lengths)
    for s in sorted(set(lengths)):           # this cell's shapes, once each
        programs.lm_prefill(mcfg, params, pool[:p["batch"], :s]).cpu()
    return st


def _tokens(st: State, batch: int, k: int, s: int) -> torch.Tensor:
    rows = (np.arange(batch) + k * batch) % st.pool.shape[0]
    return st.pool[torch.as_tensor(rows, device=st.pool.device), :s]


def drive(run, st: State) -> dict:
    p = run.params
    b = p["batch"]
    sched = schedule(st.lengths, p["max_calls"])
    tracer = run.tracer
    clock = time.perf_counter
    calls = []        # (k, length, host seconds, in the slice)
    logits = {}
    attempted = 0
    t0 = clock()
    for k, s in enumerate(sched):
        tracer.tick(clock() - t0)
        attempted += 1
        toks = _tokens(st, b, k, s)
        ts = clock()
        out = programs.lm_prefill(st.mcfg, st.params, toks)
        lg = out[:, -1, :].float().cpu()
        te = clock()
        logits[k] = lg
        calls.append((k, s, te - ts, tracer.active))
        if te - t0 >= run.seconds:
            window = te - t0
            break
    else:
        raise RuntimeError(f"{run.cell}: max_calls {p['max_calls']} ran out "
                           f"before the window closed")
    tracer.stop()
    tokens = sum(b * c[1] for c in calls)
    c_in = [c for c in calls if c[3]]
    c_out = [c for c in calls if not c[3]]
    return {
        "e2e": {"prefill_tokens_per_s": tokens / window},
        "attempted": attempted, "failed": 0, "logits": logits,
        "calls": calls, "batch": b,
        "tokens_in": sum(b * c[1] for c in c_in),
        "lengths_in": [c[1] for c in c_in],
        "flops_out": sum(work.prefill_flops(st.sizes, b, c[1])
                         for c in c_out),
        "time_out": window - run.tracer.taken_s,
        "sizes": st.sizes,
    }


def sample(run, record: dict) -> list:
    """The calls the check compares: the longest (the first of them) and
    ``check_calls - 1`` others drawn from the seed."""
    calls = record["calls"]
    n = min(run.params["check_calls"], len(calls))
    longest = max(range(len(calls)), key=lambda i: (calls[i][1], -i))
    rest = [i for i in range(len(calls)) if i != longest]
    rng = np.random.default_rng(run.seed + 2)
    picked = rng.choice(len(rest), size=n - 1, replace=False) if n > 1 else []
    return [calls[longest]] + [calls[rest[i]] for i in sorted(picked)]


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| of each row."""
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1))


def check(run, st: State, record: dict, control: bool = False,
          look: bool = False) -> dict:
    """The sampled calls' last-position logits against the plain float32
    reference's: the relative L2 gap ||got - want|| / ||want|| of each
    row, and its median over the rows (bf16 routing near-ties move single
    rows by far more than rounding does; see PERF.md). The control: the
    reference computed with float8 products in the program's place.
    ``look`` adds, for each row, the gap of the reference computed in
    bfloat16 and the routing choices at the last position that differ
    between the two (kept in ``record["look"]``)."""
    b = record["batch"]
    picked = sample(run, record)
    record["logits"] = {c[0]: record["logits"][c[0]] for c in picked}
    gc.collect()
    if st.pool.is_cuda:
        torch.cuda.empty_cache()
    gaps, rows = [], []
    for k, s, _, _ in picked:
        toks = _tokens(st, b, k, s)
        routes: list | None = [] if look else None
        want = deepseek_v2_plain.last_logits(st.sizes, st.params, toks,
                                             routes=routes)
        got = (deepseek_v2_plain.last_logits(st.sizes, st.params, toks,
                                             quant="fp8")
               if control else record["logits"][k].to(want.device))
        gap = rel_gap(got, want)
        gaps.extend(gap.tolist())
        if look:
            r16: list = []
            w16 = deepseek_v2_plain.last_logits(st.sizes, st.params, toks,
                                                quant="bf16", routes=r16)
            g16 = rel_gap(w16, want).tolist()
            for j in range(b):
                flips = sum(len(set(a[0]) - set(c[0]))
                            for a, c in zip(routes[j], r16[j]))
                rows.append({"call": k, "len": s, "gap": gap[j].item(),
                             "gap_bf16_ref": g16[j], "route_flips": flips,
                             "min_margin": min(m for _, m in routes[j])})
    record["look"] = rows
    return {"logit_rel_err_median": float(np.median(gaps))}
