"""Streaming BCNN serving on the GPU — the paper's online
individual-request scenario (§6.3, Fig. 7) as a runnable service loop
(counterpart of ``repro/launch/serve_bcnn.py``: the single engine, its
stage-pipelined step, ``--offline``'s bulk and slot routes, and the
replica fleet).

Builds the 9-layer CIFAR-10 BCNN — random weights folded on the spot, or
trained weights from a deployment artifact (``--artifact``, the format of
``core/bcnn_artifact.py``) — and serves synthetic CIFAR-like images
through the slot engine (``serve/bcnn_engine.py``). Reports per-request
latency percentiles and throughput.

The kernel plan comes from the per-knob flags (``--path``,
``--conv-strategy``, ``--conv-fusion``), or from the tuner: a cached plan
in ``--tuning-cache`` or ``--artifact`` whose key matches this host is
reused (``tuning: cache hit``), else ``--autotune`` measures one on the
engine's device. ``--export-artifact DIR`` writes the served weights, and
a measured plan as the artifact's ``tuning`` section.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --device cuda \\
        --conv-fusion --autotune --export-artifact build/bcnn_art
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --device cuda \\
        --artifact build/bcnn_art --autotune   # reuses the stored plan
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --rate 200 \\
        --slots 4 --requests 64        # Poisson arrivals at 200 req/s
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --device cpu \\
        --requests 4                   # plain PyTorch path, no GPU
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --offline \\
        --requests 64                  # one batch through classify_batch
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn \\
        --pipeline-stages 2            # the step cut into 2 stages
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --data-shards 1 \\
        --offline --requests 256       # the bulk data-parallel route
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --replicas 2 \\
        --rate 200 --rolling-swap      # FLEET: the router over 2 replicas,
        # mixed online + bulk Poisson traffic, the weights hot-swapped
        # replica by replica halfway through (serve/router.py)
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --replicas 1 \\
        --autoscale --max-replicas 2   # ELASTIC fleet (serve/autoscale.py)

On the card every served step is one CUDA-graph replay (one graph per
replica, or per pipeline stage, ``step_cache_size`` 1, printed), the bulk
route holds one graph per shard or stage (``batch_cache_size`` 1), and a
swap copies the new weights into the captured buffers in place.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import bcnn_cifar10 as pc
from repro_torch.core import bcnn
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.serve.bcnn_engine import BCNNEngine, drive_poisson


def parse_priority_mix(spec: str) -> dict[str, int]:
    """'online=3,bulk=1' → {"online": 3, "bulk": 1} (validated)."""
    mix = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition("=")
        try:
            weight = int(w)
        except ValueError:
            raise SystemExit(f"--priority-mix: bad weight in {part!r} "
                             f"(want 'class=int,...')")
        if weight < 0:
            raise SystemExit(f"--priority-mix: negative weight in {part!r}")
        mix[name.strip()] = weight
    if not mix or not any(mix.values()):
        raise SystemExit("--priority-mix: no positive weights")
    return mix


def resolve_plan(packed, args):
    """``--autotune`` / ``--tuning-cache`` → the ExecutionPlan to serve
    with, or None (no tuning flags: the engine builds the heuristic plan
    from the per-knob flags).

    Cache first: a usable ``tuning`` section in ``--tuning-cache`` (or,
    failing that, ``--artifact``) whose key matches this host is reused
    without measuring; only then does ``--autotune`` measure.
    """
    if not (args.autotune or args.tuning_cache):
        return None
    from repro_torch.core import bcnn_artifact
    from repro_torch.core import execution_plan as xp
    from repro_torch.kernels import autotune as at
    tuning = None
    for cache_dir in (args.tuning_cache, args.artifact):
        if not cache_dir:
            continue
        try:
            tuning = bcnn_artifact.load_tuning(cache_dir)
        except bcnn_artifact.ArtifactError as e:
            print(f"tuning: cache at {cache_dir} unusable ({e})")
            tuning = None
        if tuning is not None:
            break
    plan, source = at.plan_for_host(packed, tuning, args.device)
    if source == "cached":
        key = xp.plan_key_fingerprint(tuning["key"])
        print(f"tuning: cache hit on key {key} — reusing the stored plan "
              f"({plan.path} path, fusion "
              f"{'on' if plan.conv_fusion else 'off'}) without re-measuring")
    elif args.autotune:
        report = {}
        plan = at.autotune_packed(packed, device=args.device,
                                  batch=args.slots, report=report)
        print(f"tuning: measured {report['n_candidates']} candidate(s) "
              f"({report['n_eligible']} eligible) → {plan.path} path, "
              f"fusion {'on' if plan.conv_fusion else 'off'}, tiles "
              f"{list(plan.group_tiles)}")
    else:
        print("tuning: no usable cached plan for this host — serving the "
              "default heuristics (pass --autotune to measure)")
    return plan


def export_artifact(path, packed, plan, args) -> None:
    """``--export-artifact``: persist the served weights and, when the
    plan was measured, its ``tuning`` section."""
    from repro_torch.core import bcnn_artifact
    from repro_torch.kernels import autotune as at
    tuning = (at.tuning_section(packed, plan, args.device)
              if plan is not None and plan.tuned else None)
    bcnn_artifact.save_packed(path, packed, tuning=tuning,
                              provenance={"seed": args.seed,
                                          "exported_by": "serve_bcnn"})
    print(f"exported artifact to {path}"
          + (" (with tuning section)" if tuning else ""))


def serve_fleet(packed, x, args, plan=None) -> int:
    """The fleet tier: the router over ``--replicas`` engine replicas,
    optionally elastic (``--autoscale``: a controller thread walks the
    replica count between the hysteresis watermarks as load changes)."""
    from repro_torch.serve import AutoscaleConfig, Router, \
        drive_mixed_poisson

    mix = parse_priority_mix(args.priority_mix)
    autoscale = None
    if args.autoscale:
        autoscale = AutoscaleConfig(
            min_replicas=args.min_replicas, max_replicas=args.max_replicas,
            up_watermark=pc.AUTOSCALE_UP_WATERMARK,
            down_watermark=pc.AUTOSCALE_DOWN_WATERMARK,
            window_s=pc.AUTOSCALE_WINDOW_S,
            cooldown_s=pc.AUTOSCALE_COOLDOWN_S,
            interval_s=pc.AUTOSCALE_INTERVAL_S)
    router = Router.from_packed(
        packed, n_replicas=args.replicas, n_slots=args.slots,
        path=args.path, conv_strategy=args.conv_strategy,
        conv_fusion=args.conv_fusion, plan=plan, device=args.device,
        max_queue=args.max_queue, history=max(4096, args.requests),
        online_reserve=args.online_reserve,
        bulk_chunk=args.bulk_chunk if args.bulk_chunk > 0 else None,
        autoscale=autoscale)
    try:
        unknown = set(mix) - set(router.class_names)
        if unknown:
            raise SystemExit(f"--priority-mix: unknown class(es) "
                             f"{sorted(unknown)} (router classes: "
                             f"{sorted(router.class_names)})")
        swap_to = None
        if args.rolling_swap:
            # hot-swap target: a re-seeded fold of the same architecture
            swap_to = bcnn.fold_model(bcnn.init(
                torch.Generator().manual_seed(args.seed + 1)))
        elastic = (f", elastic {args.min_replicas}..{args.max_replicas} "
                   f"replicas (reserve {args.online_reserve})"
                   if autoscale else "")
        print(f"fleet: {args.replicas} replicas × {args.slots} slots on "
              f"{args.device}, admission queue {args.max_queue}, mix "
              + ", ".join(f"{k}={v}" for k, v in mix.items()) + elastic)
        if args.rate > 0:
            d = drive_mixed_poisson(router, x, args.rate, mix=mix,
                                    seed=args.seed, swap_to=swap_to)
            print(f"mixed Poisson arrivals @ {args.rate:.1f} req/s: "
                  f"{d['n_accepted']}/{d['n_offered']} admitted, "
                  f"{d['n_rejected']} shed")
            if swap_to is not None:
                print(f"  rolling swap mid-drive: weight epochs served = "
                      f"{sorted(d['epochs'])} (zero drops)")
        else:
            # bulk burst up front: with --autoscale this is the load step
            # that crosses the up-watermark (requests ≫ slots), so the
            # controller must scale up while the backlog drains
            reqs = router.submit_batch(x, cls="bulk")
            if autoscale is not None:
                # sample the burst into the pressure window synchronously
                # rather than race the controller thread against the drain
                for _ in range(8):
                    if router.autoscaler.step() > 0:
                        break
            if swap_to is not None:
                router.rolling_swap(swap_to)
            for r in reqs:
                r.wait(timeout=120.0)
            print(f"batch-of-{args.requests} submitted up front via router")
            if swap_to is not None:
                print(f"  rolling swap mid-burst: weight epochs served = "
                      f"{sorted({r.epoch for r in reqs})} (zero drops)")
        for cls in router.class_names:
            st = router.stats(cls)
            if st["n"] == 0:
                continue
            miss = (f", deadline-miss {st['deadline_miss_frac'] * 100:.0f}%"
                    if st.get("deadline_miss_frac") is not None else "")
            print(f"  [{cls}] n={st['n']}  p50 {st['p50'] * 1e3:8.3f} ms  "
                  f"p95 {st['p95'] * 1e3:8.3f} ms  "
                  f"p99 {st['p99'] * 1e3:8.3f} ms{miss}")
        if autoscale is not None:
            a = router.autoscaler
            timeline = [(round(t, 3), n)
                        for t, n in a.timeline(args.replicas)]
            print(f"  autoscaler: {a.n_scale_ups} scale-up(s), "
                  f"{a.n_scale_downs} scale-down(s), timeline {timeline}")
            if (args.rate == 0 and args.max_replicas > args.replicas
                    and args.requests
                    > pc.AUTOSCALE_UP_WATERMARK * args.slots
                    and a.n_scale_ups < 1):
                # the burst held the pressure above the up-watermark for
                # its whole drain: a scale-up is guaranteed, not hoped for
                raise SystemExit("burst crossed the up-watermark but no "
                                 "replica spawned")
        for rep in router.replicas_ever:
            live = "live" if rep in router.replicas else "retired"
            print(f"  replica {rep.id} ({live}): served {rep.served}, "
                  f"weight epoch {rep.epoch}, step_cache_size "
                  f"{rep.step_cache_size}")
            if rep.step_cache_size != 1:
                raise SystemExit(f"replica {rep.id} captured its step "
                                 f"{rep.step_cache_size} times")
    finally:
        router.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default="", metavar="DIR",
                    help="serve weights from a deployment artifact "
                         "(core/bcnn_artifact.py format) instead of "
                         "randomly initialized ones")
    ap.add_argument("--slots", type=int, default=pc.SERVE_N_SLOTS)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s; 0 = all up front")
    ap.add_argument("--path", default="auto",
                    choices=["auto", "xla", "mxu", "vpu"],
                    help="kernel path (auto: mxu on the GPU, xla on the "
                         "CPU)")
    ap.add_argument("--conv-strategy", default=pc.CONV_STRATEGY,
                    choices=["auto", "direct", "im2col"])
    ap.add_argument("--conv-fusion", action="store_true",
                    default=pc.CONV_FUSION,
                    help="fuse CONV-3/4 and CONV-5/6 into the K5 kernel "
                         "(bit-exact; the bit map between the two convs "
                         "stays on chip)")
    ap.add_argument("--pipeline-stages", type=int,
                    default=pc.PIPELINE_STAGES,
                    help="cut the 9-layer forward into N cost-balanced "
                         "pipeline stages over the CUDA devices "
                         "(parallel/bcnn_pipeline.py; stages share a "
                         "card when there are fewer cards); 1 = one "
                         "PackedForward")
    ap.add_argument("--micro-batch", type=int,
                    default=pc.PIPELINE_MICRO_BATCH,
                    help="pipeline streaming granule (with "
                         "--pipeline-stages)")
    ap.add_argument("--data-shards", type=int, default=pc.DATA_SHARDS,
                    help="replicate the packed network over N devices and "
                         "shard bulk batches across them "
                         "(parallel/bcnn_data_parallel.py); 0 = disabled")
    ap.add_argument("--data-micro-batch", type=int,
                    default=pc.DATA_MICRO_BATCH,
                    help="per-shard granule of the data-parallel forward "
                         "(with --data-shards)")
    ap.add_argument("--offline", action="store_true",
                    help="serve all --requests images as ONE batch "
                         "through classify_batch (the bulk route with "
                         "--data-shards, else the slot route) instead of "
                         "streaming them")
    ap.add_argument("--replicas", type=int, default=pc.ROUTER_REPLICAS,
                    help="serve through the fleet router (serve/router.py) "
                         "over N engine replicas, each stepped on its own "
                         "thread and CUDA stream; 1 = single engine, no "
                         "router (the default)")
    ap.add_argument("--priority-mix", default=pc.PRIORITY_MIX,
                    help="offered-traffic composition for the router "
                         "drive, 'class=weight,...' over the classes "
                         "online (deadline-carrying) and bulk "
                         "(best-effort)")
    ap.add_argument("--max-queue", type=int, default=pc.ROUTER_MAX_QUEUE,
                    help="router admission-queue bound; past it requests "
                         "are shed with a typed RouterOverload")
    ap.add_argument("--rolling-swap", action="store_true",
                    help="with --replicas >= 2 (or --autoscale): hot-swap "
                         "the fleet to a re-seeded weight set halfway "
                         "through the drive (rolling walk — traffic never "
                         "drops)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet (serve/autoscale.py): a controller "
                         "thread scales the replica count between "
                         "--min-replicas and --max-replicas as offered "
                         "load crosses the hysteresis watermarks "
                         "(AUTOSCALE_* in configs/bcnn_cifar10.py)")
    ap.add_argument("--min-replicas", type=int,
                    default=pc.AUTOSCALE_MIN_REPLICAS,
                    help="autoscaler floor (with --autoscale)")
    ap.add_argument("--max-replicas", type=int,
                    default=pc.AUTOSCALE_MAX_REPLICAS,
                    help="autoscaler ceiling (with --autoscale)")
    ap.add_argument("--online-reserve", type=int, default=pc.ONLINE_RESERVE,
                    help="per-replica dispatch slots bulk chunks may never "
                         "occupy (fleet tier) — keeps online latency flat "
                         "under a co-scheduled bulk batch; 0 disables")
    ap.add_argument("--bulk-chunk", type=int, default=pc.BULK_CHUNK,
                    help="micro-chunk size bulk batches are split into for "
                         "co-scheduling (fleet tier); 0 = one request per "
                         "image")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the kernel plan on the engine's device "
                         "(kernels/autotune.py) unless a cached plan "
                         "matches this host")
    ap.add_argument("--tuning-cache", default="", metavar="DIR",
                    help="artifact whose tuning section to reuse when its "
                         "key matches this host")
    ap.add_argument("--export-artifact", default="", metavar="DIR",
                    help="write the served weights (and a measured plan) "
                         "as a deployment artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when there is no GPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.artifact:
        from repro_torch.core import bcnn_artifact
        packed = bcnn_artifact.load_packed(args.artifact)
        prov = bcnn_artifact.load_manifest(args.artifact)["provenance"]
        print(f"serving artifact {args.artifact} "
              f"(trained {prov.get('steps', '?')} steps, "
              f"seed {prov.get('seed', '?')})")
    else:
        packed = bcnn.fold_model(bcnn.init(
            torch.Generator().manual_seed(args.seed)))
    x, _ = SyntheticImages(global_batch=args.requests,
                           seed=args.seed).batch(0)
    plan = resolve_plan(packed, args)
    if args.export_artifact:
        export_artifact(args.export_artifact, packed, plan, args)
    if args.replicas >= 2 or args.autoscale:
        return serve_fleet(packed, x, args, plan=plan)
    if args.rolling_swap:
        raise SystemExit("--rolling-swap needs --replicas >= 2 or "
                         "--autoscale (the rolling walk is a fleet-tier "
                         "operation)")
    eng = BCNNEngine.from_packed(packed, n_slots=args.slots, path=args.path,
                                 conv_strategy=args.conv_strategy,
                                 conv_fusion=args.conv_fusion, plan=plan,
                                 device=args.device,
                                 pipeline_stages=args.pipeline_stages,
                                 pipeline_micro_batch=args.micro_batch,
                                 data_shards=args.data_shards,
                                 data_micro_batch=args.data_micro_batch,
                                 history=max(4096, args.requests))
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu")
    print(f"engine on {where}: {args.slots} slots, path {eng.plan.path}, "
          f"conv strategy {eng.plan.conv_strategy[1]}, fusion "
          f"{'on' if eng.plan.conv_fusion else 'off'}")
    if args.pipeline_stages > 1:
        sp = eng.forward.plan
        print(f"pipelined forward: {sp.n_stages} stages over "
              f"{len(set(eng.forward.devices))} device(s), "
              f"micro-batch {args.micro_batch}")
        for s in range(sp.n_stages):
            print(f"  stage {s}: {' + '.join(sp.stage_layers(s))}  "
                  f"(cost {sp.stage_costs[s]:.3g})")
    if eng.batch_forward is not None:
        dp = eng.batch_forward.plan
        print(f"data-parallel bulk forward: {dp.data_shards} shard(s) × "
              f"{dp.n_stages} stage(s), micro-batch {dp.micro_batch} "
              f"(chunk {dp.chunk}; classify_batch routes batches >= "
              f"{eng.batch_threshold})")
    if args.offline:
        eng.classify_batch(x)           # warm: the route's captures
        t0 = time.perf_counter()
        logits = eng.classify_batch(x)
        dt = time.perf_counter() - t0
        if logits.shape != (args.requests, pc.N_CLASSES):
            raise SystemExit(f"offline logits {logits.shape}")
        bulk = (eng.batch_forward is not None
                and args.requests >= eng.batch_threshold)
        print(f"offline batch of {args.requests}: "
              f"{args.requests / dt:.1f} img/s ({dt * 1e3:.1f} ms wall, "
              f"via the {'bulk' if bulk else 'slot'} path; "
              f"step_cache_size {eng.step_cache_size}, batch_cache_size "
              f"{eng.batch_cache_size})")
        return 0
    if args.rate > 0:
        d = drive_poisson(eng, x, args.rate, seed=args.seed)
        out, st = d["results"], d["stats"]
        print(f"Poisson arrivals @ {args.rate:.1f} req/s:")
    else:
        eng.warmup()
        t0 = time.perf_counter()
        for img in x:
            eng.submit(img)
        out = eng.run()
        dt = time.perf_counter() - t0
        st = eng.stats(last_n=args.requests)
        print(f"batch-of-{args.requests} submitted up front "
              f"({dt:.3f}s wall):")
    if len(out) != args.requests:
        raise SystemExit(f"engine dropped requests: {len(out)} of "
                         f"{args.requests} served")
    hz = (f"{st['throughput']:.1f}" if st["throughput"] is not None
          else "n/a")
    print(f"  served {st['n']}/{args.requests} requests, {hz} img/s over "
          f"{eng.steps_executed} steps ({args.slots} slots, "
          f"step_cache_size {eng.step_cache_size})")
    print(f"  latency  p50 {st['p50'] * 1e3:8.3f} ms   "
          f"p95 {st['p95'] * 1e3:8.3f} ms   p99 {st['p99'] * 1e3:8.3f} ms")
    print(f"  queue-wait p50 {st['queue_p50'] * 1e3:6.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
