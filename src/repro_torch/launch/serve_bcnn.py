"""Streaming BCNN serving on the GPU — the paper's online
individual-request scenario (§6.3, Fig. 7) as a runnable service loop
(counterpart of ``repro/launch/serve_bcnn.py``, single-engine path).

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
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import bcnn_cifar10 as pc
from repro_torch.core import bcnn
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.serve.bcnn_engine import BCNNEngine, drive_poisson


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
    eng = BCNNEngine.from_packed(packed, n_slots=args.slots, path=args.path,
                                 conv_strategy=args.conv_strategy,
                                 conv_fusion=args.conv_fusion, plan=plan,
                                 device=args.device,
                                 history=max(4096, args.requests))
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu")
    print(f"engine on {where}: {args.slots} slots, path {eng.plan.path}, "
          f"conv strategy {eng.plan.conv_strategy[1]}, fusion "
          f"{'on' if eng.plan.conv_fusion else 'off'}")
    if args.export_artifact:
        export_artifact(args.export_artifact, packed, plan, args)
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
          f"{eng.steps_executed} steps ({args.slots} slots)")
    print(f"  latency  p50 {st['p50'] * 1e3:8.3f} ms   "
          f"p95 {st['p95'] * 1e3:8.3f} ms   p99 {st['p99'] * 1e3:8.3f} ms")
    print(f"  queue-wait p50 {st['queue_p50'] * 1e3:6.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
