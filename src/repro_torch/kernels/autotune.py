"""Measure-and-cache kernel tuner (counterpart of
``repro/kernels/autotune.py``).

It times the legal candidate space on the serving device and returns the
winning ``core/execution_plan.py::ExecutionPlan``, which
``core/bcnn_artifact.py::save_packed`` persists in the artifact's
``tuning`` section so the next load on the same card reuses it.

Candidate space (per layer / pair, legality shared with the heuristics):

* kernel ``path`` — ("vpu", "mxu") on a CUDA device, ("xla",) on the CPU,
  where the plain version is the only implementation;
* conv ``strategy`` per binary conv — "direct" where
  ``core/bconv.py::resolve_strategy`` allows it, "im2col" always;
* fused-pair (th, tw) tiles — every power-of-two tile up to (TH, TW) that
  ``kernels/xnor_conv_fused.py::tile_fits`` allows, the rule
  ``pick_tiles`` applies;
* fusion on/off — the fused pairs raced against their two-layer
  sequential fold.
* the XNOR LM's decode GEMM mode, "bw" (K6) against "xnor" (K1/K2), on
  one ``models/xnor_lm.py::decode_step`` at the served slot count
  (``autotune_lm_mode``).

Protocol: ``warmup`` untimed calls, then ``reps`` timed calls at the
served batch, scored by their median and spread (``measure``). On a CUDA
device the time is device time (``device_times``): the paths launch the
same number of kernels, so the host's launch cost, which is most of a
layer's wall time at the served batch and varies more than the gap
between the paths, does not decide. Elsewhere, or with an injected clock
(``timer``, which the tests fake), it is wall time around a call that
ends in a device sync. Every race starts from the heuristic choice of
``default_plan``, which a challenger displaces only when it is faster by
more than the two spreads together (``_pick``), so noise cannot flip the
plan. Every layer's reference output comes from the plain path on a CPU
copy of the net, and every candidate is compared with it on the CPU: a
candidate that differs is not eligible, and the assembled plan's logits
must equal the CPU's exactly before it is returned. Nothing is caught: a
kernel that raises makes the tuner raise.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import bcnn, bconv, execution_plan
from repro_torch.kernels import xnor_conv_fused as kfused

AUTOTUNE_REPS = 21         # timed calls per candidate (median and spread)
AUTOTUNE_WARMUP = 1        # untimed calls first (kernel build, caches)
AUTOTUNE_BATCH = 4         # probe batch: the served 4 slots by default
LM_PROBE_STEPS = 8         # LM decode steps whose logits the modes compare
# A time's spread is at least this share of its median: one kernel's
# device time repeated within 3% between two chip runs (PERF.md §5).
TIE_REL = 0.03


def backend_paths(backend: str) -> tuple[str, ...]:
    """Kernel-path candidates: the two CUDA kernel families on "cuda",
    the plain version on "cpu"."""
    return ("vpu", "mxu") if backend == "cuda" else ("xla",)


def strategy_candidates(fp, c: int) -> tuple[str, ...]:
    """Legal conv dataflows for a layer with ``c`` input channels — the
    rule of ``core/bconv.py::resolve_strategy``."""
    cands = []
    if fp.w_words_hw is not None and c % 32 == 0:
        cands.append("direct")
    cands.append("im2col")
    return tuple(cands)


def tile_candidates(ho: int, wo: int, **geom) -> tuple[tuple[int, int], ...]:
    """Every legal (th, tw) fused-pair tile: powers of two up to
    ``block_for(extent, TH/TW)`` that ``tile_fits``. ``geom``: the
    ``halo_scratch`` geometry. ``pick_tiles``'s choice is a member."""
    def po2_up_to(m: int) -> list[int]:
        out, t = [], 1
        while t <= m:
            out.append(t)
            t *= 2
        return out

    return tuple((th, tw)
                 for th in po2_up_to(kfused.block_for(ho, kfused.TH))
                 for tw in po2_up_to(kfused.block_for(wo, kfused.TW))
                 if kfused.tile_fits(th, tw, **geom))


def enumerate_candidates(packed, backend: str, *,
                         input_hw: tuple[int, int] = (32, 32)) -> dict:
    """The full legal candidate space, per layer and pair — what
    ``autotune_packed`` races."""
    space = {"paths": backend_paths(backend), "convs": {}, "pairs": {}}
    for idx in range(1, 6):
        fp = packed.convs[idx - 1]
        c = fp.k // (fp.fh * fp.fw)
        space["convs"][idx] = {"strategies": strategy_candidates(fp, c)}
    for group in bcnn.plan_layer_groups(conv_fusion=True):
        if len(group) != 2:
            continue
        pg = execution_plan.pair_geometry(packed, group[0], input_hw)
        space["pairs"][group[0]] = {
            "pool_b": pg["pf"] == 2,
            "tiles": tile_candidates(pg["ho"], pg["wo"], **pg["geom"]),
        }
    return space


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def _block(x):
    """Wait for the device work behind ``x`` (the counterpart of the
    reference's ``block_until_ready``)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def device_times(fn, reps: int, per_gate: int | None = None) -> list[float]:
    """Device seconds of each of ``reps`` calls of ``fn`` on the current
    CUDA device: CUDA events around calls queued behind a sleep kernel,
    so the device runs them back to back and no host launch cost falls
    inside an interval. The sleep is lengthened until the host gets ahead
    of it. ``fn`` must not synchronize, and the calls queued behind one
    sleep (``per_gate``, default all ``reps``) x launches per call must
    stay well under the device's queue of pending launches (about a
    thousand), or the host blocks on a full queue."""
    per_gate = per_gate or reps
    ts: list[float] = []
    while len(ts) < reps:
        ts += _gated_times(fn, min(per_gate, reps - len(ts)))
    return ts


def _gated_times(fn, reps: int) -> list[float]:
    cycles = 20_000_000
    while cycles < 3 * 10 ** 9:
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        gate = torch.cuda.Event()
        gate.record()
        for s, e in ev:
            s.record()
            fn()
            e.record()
        queued_behind_sleep = not gate.query()
        torch.cuda.synchronize()
        if queued_behind_sleep:
            return [s.elapsed_time(e) / 1e3 for s, e in ev]
        cycles *= 4
    raise RuntimeError("device_times: the host never got ahead of the "
                       "device (a sync or a full launch queue in the call)")


def measure(fn, *, device, timer=None, reps: int = AUTOTUNE_REPS,
            warmup: int = AUTOTUNE_WARMUP,
            per_gate: int | None = None) -> tuple[float, float]:
    """(median, spread) in seconds of ``reps`` calls of ``fn`` after
    ``warmup`` untimed ones: device time on a CUDA ``device`` when no
    ``timer`` is given (``device_times``, ``per_gate`` calls behind each
    sleep), else wall time by the clock ``timer`` (default
    ``time.perf_counter``) around calls that each end in a device sync.
    The spread is the interquartile range, at least ``TIE_REL`` of the
    median."""
    for _ in range(warmup):
        _block(fn())
    if timer is None and device.type == "cuda":
        ts = device_times(fn, reps, per_gate)
    else:
        timer = timer or time.perf_counter
        ts = []
        for _ in range(reps):
            t0 = timer()
            _block(fn())
            ts.append(timer() - t0)
    ts.sort()
    n = len(ts)
    median = ts[n // 2]
    return median, max(ts[(3 * n) // 4] - ts[n // 4], TIE_REL * median)


def _race(cands, ref, *, device, timer, reps, warmup, rows) -> dict:
    """Time the candidates (label, fn) whose output equals ``ref`` (a CPU
    tensor) exactly → {label: (median, spread)} in race order; appends
    one row per candidate to ``rows``."""
    scores = {}
    for label, fn in cands:
        ok = bool(torch.equal(fn().cpu(), ref))
        if ok:
            scores[label] = measure(fn, device=device, timer=timer,
                                    reps=reps, warmup=warmup)
        median, spread = scores.get(label, (None, None))
        rows.append({"candidate": label, "eligible": ok, "median_s": median,
                     "spread_s": spread})
    return scores


def _pick(scores: dict):
    """The first label, in ``scores``' order, whose median is within the
    two spreads of the fastest one's, or None when ``scores`` is empty.
    Callers put the heuristic choice first, so it is displaced only by a
    challenger that beats it by more than the noise."""
    if not scores:
        return None
    fastest, spread = min(scores.values())
    for label, (t, s) in scores.items():
        if t - fastest <= s + spread:
            return label


def _first(seq, head):
    """``seq`` reordered with ``head`` first (where it is a member)."""
    return sorted(seq, key=lambda x: x != head)


def tile_race_order(tiles, head):
    """The order a fused pair's tiles race in: the heuristic ``head``
    first, then the rest by decreasing area and, at equal area, the
    squarer first. A larger, squarer tile recomputes less halo, and
    ``_pick`` takes the first tile within noise of the fastest, so among
    tiles it cannot tell apart the one that recomputes least wins. In the
    order of ``tile_candidates`` a slower, thinner tile raced before the
    fastest and sat at the edge of the noise band, and two tunings split
    on it."""
    return _first(sorted(tiles, key=lambda t: (-t[0] * t[1],
                                               max(t) / min(t))), head)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

def autotune_packed(packed, *, device="cuda",
                    input_hw: tuple[int, int] = (32, 32),
                    batch: int = AUTOTUNE_BATCH,
                    timer=None, reps: int = AUTOTUNE_REPS,
                    warmup: int = AUTOTUNE_WARMUP, seed: int = 0,
                    report: dict | None = None):
    """Measure the candidate space for ``packed`` on ``device`` at
    ``batch`` images → the winning ``ExecutionPlan`` (``tuned=True``).

    1. run the plain forward on a CPU copy, layer by layer, keeping every
       layer's input and output;
    2. per binary conv race the strategies under each path, per FC time
       each path; the global ``path`` is raced on the summed per-layer
       medians (spreads summed too);
    3. under that path, race every legal tile of each fused pair, in
       ``tile_race_order``; fusion is raced on the summed fused times
       against the pairs' sequential ones;
    4. require the assembled plan's logits on ``device`` to equal the CPU
       logits exactly.

    Every race goes to ``_pick`` with ``default_plan``'s choice first.
    ``report`` (optional dict) receives the per-candidate rows, counts,
    the path and fusion (median, spread) totals, the plan and its cache
    key.
    """
    device = execution_plan.resolve_device(device)
    backend = execution_plan.backend_of(device)
    packed_cpu = bcnn.packed_to(packed, "cpu")
    packed = bcnn.packed_to(packed, device)
    base = execution_plan.default_plan(packed, device, input_hw=input_hw)
    paths = _first(backend_paths(backend), base.path)
    rows = []

    gen = torch.Generator().manual_seed(seed)
    x01 = torch.rand((batch, *input_hw, 3), generator=gen)

    # 1. plain reference on the CPU: per-layer inputs and outputs
    inputs, refs = {}, {}
    h = x01
    for idx in range(bcnn.N_LAYERS):
        inputs[idx] = h.to(device)
        h = bcnn.apply_packed_layer(packed_cpu, idx, h, path="xla",
                                    conv_strategy=base.strategy_for(idx))
        refs[idx] = h
    logits_ref = h

    def race(cands, ref):
        return _race(cands, ref, device=device, timer=timer, reps=reps,
                     warmup=warmup, rows=rows)

    def total(scores):
        scores = list(scores)
        return (sum(t for t, _ in scores), sum(s for _, s in scores))

    # 2. per-layer races → the global path and per-layer strategies
    best = {p: {} for p in paths}        # [path][idx] = (label, (t, spread))
    for p in paths:
        for idx in range(1, 6):
            fp = packed.convs[idx - 1]
            c = fp.k // (fp.fh * fp.fw)
            mp = bcnn.CONV_SPECS[idx][2]
            scores = race(
                [(f"conv{idx}:{p}:{s}",
                  lambda fp=fp, idx=idx, p=p, s=s: bconv.apply_packed(
                      fp, inputs[idx], maxpool=mp, path=p, strategy=s))
                 for s in _first(strategy_candidates(fp, c),
                                 base.strategy_for(idx))], refs[idx])
            label = _pick(scores)
            if label is not None:
                best[p][idx] = (label, scores[label])
        for idx in (6, 7, 8):
            label = f"fc{idx}:{p}"
            scores = race([(label, lambda idx=idx, p=p:
                            bcnn.apply_packed_layer(packed, idx, inputs[idx],
                                                    path=p))], refs[idx])
            if label in scores:
                best[p][idx] = (label, scores[label])

    totals = {p: (total(sc for _, sc in best[p].values())
                  if len(best[p]) == bcnn.N_LAYERS - 1 else None)
              for p in paths}
    win_path = _pick({p: t for p, t in totals.items() if t is not None}) \
        or base.path
    strategies = list(base.conv_strategy)
    for idx in range(1, 6):
        if idx in best.get(win_path, {}):
            strategies[idx] = best[win_path][idx][0].rsplit(":", 1)[1]

    # 3. fused pairs under the winning path: tiles vs the sequential fold
    group_tiles, fused, seq = [], [], []
    space = enumerate_candidates(packed, backend, input_hw=input_hw)
    default_tiles = {i: (th, tw) for i, th, tw in
                     execution_plan.default_group_tiles(
                         packed, bcnn.plan_layer_groups(conv_fusion=True),
                         input_hw=input_hw)}
    for i, pair in sorted(space["pairs"].items()):
        fa, fb = packed.convs[i - 1], packed.convs[i]
        tiles = (tile_race_order(pair["tiles"], default_tiles[i])
                 if win_path != "xla" else (None,))
        by_label = {f"pair{i}:{win_path}:tiles={tl}": tl for tl in tiles}
        scores = race([(label,
                        lambda fa=fa, fb=fb, i=i, tl=tl:
                        bconv.apply_packed_pair(
                            fa, fb, inputs[i], maxpool_b=pair["pool_b"],
                            path=win_path, tiles=tl))
                       for label, tl in by_label.items()], refs[i + 1])
        label = _pick(scores)
        if label is None or i not in best[win_path] \
                or i + 1 not in best[win_path]:
            group_tiles = []
            break
        tl = by_label[label]
        group_tiles.append((i, *(tl or default_tiles[i])))
        fused.append(scores[label])
        seq += [best[win_path][i][1], best[win_path][i + 1][1]]
    fusion_race = {}
    if group_tiles:
        times = {"off": total(seq), "on": total(fused)}
        for choice in ("on", "off") if base.conv_fusion else ("off", "on"):
            fusion_race[choice] = times[choice]
    fusion = _pick(fusion_race) == "on"

    plan = execution_plan.ExecutionPlan(
        path=win_path, conv_strategy=tuple(strategies), conv_fusion=fusion,
        group_tiles=tuple(group_tiles) if fusion else (), tuned=True)

    # 4. the tuned plan must be bit-exact end to end before it may ship
    tuned_logits = bcnn.forward_packed(packed, x01.to(device),
                                       plan=plan).cpu()
    if not torch.equal(tuned_logits, logits_ref):
        raise AssertionError(
            "autotuned plan is not bit-exact with the plain CPU path — "
            f"refusing to ship it: {plan}")

    if report is not None:
        report["candidates"] = rows
        report["n_candidates"] = len(rows)
        report["n_eligible"] = sum(1 for r in rows if r["eligible"])
        report["path_totals"] = totals
        report["fused_s"] = fusion_race.get("on")
        report["sequential_s"] = fusion_race.get("off")
        report["plan"] = execution_plan.plan_to_dict(plan)
        report["key"] = execution_plan.plan_cache_key(packed, device)
    return plan


def autotune_lm_mode(cfg, packed, *, device="cuda",
                     n_slots: int = AUTOTUNE_BATCH, timer=None,
                     reps: int = AUTOTUNE_REPS,
                     warmup: int = AUTOTUNE_WARMUP,
                     report: dict | None = None) -> str:
    """Race the XNOR LM's decode GEMM modes, "bw" (K6) against "xnor"
    (K1/K2 on the device's default path: "mxu" on the card), on the work
    that ``ExecutionPlan.lm_mode`` serves: one ``decode_step`` of an
    ``n_slots``-slot engine on ``device`` → the mode for
    ``ExecutionPlan.lm_mode``.

    Both modes first decode the same ``LM_PROBE_STEPS`` tokens per slot
    from an empty cache; the race runs only when every step's logits are
    equal, otherwise the default mode is returned. "bw", the default, is
    kept unless "xnor" is faster by more than the two spreads
    (``_pick``). One step, some hundreds of launches, is queued behind
    each sleep gate. ``report`` (optional dict) receives whether the
    logits were equal, each mode's (median, spread) seconds per step and
    the path of "xnor".
    """
    # imported here: the kernels layer does not depend on a model module
    from repro_torch.models import xnor_lm
    device = execution_plan.resolve_device(device)
    path = execution_plan.resolve_path("auto", device)
    packed = xnor_lm.packed_to(packed, device)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (LM_PROBE_STEPS, n_slots, 1),
                           generator=gen).to(device)
    order = _first(xnor_lm.MODES, execution_plan.DEFAULT_LM_MODE)
    states = {mode: xnor_lm.init_serve_state(cfg, n_slots, cfg.max_len,
                                             device) for mode in order}

    def step(mode, tok):
        return xnor_lm.decode_step(cfg, packed, states[mode], tok,
                                   mode=mode, path=path)[0]

    outs = [torch.cat([step(mode, t) for t in tokens]).cpu()
            for mode in order]
    equal = all(torch.equal(outs[0], o) for o in outs[1:])
    scores = {}
    if equal:
        # the timed steps go on from the probe's state; a step attends
        # over the whole cache under a mask and drops writes past it, so
        # its work does not depend on how far the lengths have run
        scores = {mode: measure(lambda mode=mode: step(mode, tokens[-1]),
                                device=device, timer=timer, reps=reps,
                                warmup=warmup, per_gate=1)
                  for mode in order}
    if report is not None:
        report["equal"] = equal
        report["scores"] = scores
        report["path"] = path
    return _pick(scores) or execution_plan.DEFAULT_LM_MODE


# ---------------------------------------------------------------------------
# Cache glue: the artifact's tuning section in and out
# ---------------------------------------------------------------------------

def tuning_section(packed, plan, device="cuda") -> dict:
    """The payload ``core/bcnn_artifact.py::save_packed`` persists (it
    adds the CRC and the section version)."""
    return {"key": execution_plan.plan_cache_key(packed, device),
            "plan": execution_plan.plan_to_dict(plan)}


def plan_for_host(packed, tuning: dict | None, device="cuda"):
    """The plan to serve with on ``device``: the cached tuned plan when
    its (backend, device kind, geometry) key matches this host, else
    ``default_plan``. Returns ``(plan, source)``, source "cached" or
    "default"; a foreign or malformed entry falls back, never raises."""
    if tuning:
        if tuning.get("key") == execution_plan.plan_cache_key(packed,
                                                              device):
            try:
                return execution_plan.plan_from_dict(tuning["plan"]), "cached"
            except (KeyError, TypeError, ValueError):
                pass                    # malformed plan payload → heuristics
    return execution_plan.default_plan(packed, device), "default"
