"""Streaming BCNN serving on the GPU — the paper's online
individual-request scenario (§6.3, Fig. 7) as a runnable service loop
(counterpart of ``repro/launch/serve_bcnn.py``, single-engine path).

Builds the 9-layer CIFAR-10 BCNN — random weights folded on the spot, or
trained weights from a deployment artifact (``--artifact``, the format of
``core/bcnn_artifact.py``) — and serves synthetic CIFAR-like images
through the slot engine (``serve/bcnn_engine.py``). Reports per-request
latency percentiles and throughput.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn --device cuda
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
    eng = BCNNEngine.from_packed(packed, n_slots=args.slots, path=args.path,
                                 conv_strategy=args.conv_strategy,
                                 device=args.device,
                                 history=max(4096, args.requests))
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "cpu")
    print(f"engine on {where}: {args.slots} slots, path {eng.plan.path}, "
          f"conv strategy {eng.plan.conv_strategy[1]}")
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
