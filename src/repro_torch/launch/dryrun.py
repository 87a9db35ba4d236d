"""Multi-pod dry-run driver of the port (counterpart of
``repro/launch/dryrun.py``).

Traces every assigned (architecture × input shape) cell on the abstract
16×16 single-pod mesh and the 2×16×16 multi-pod mesh
(``launch/mesh.py::make_production_mesh``) with fake tensors
(``launch/dryrun_lib.py``), prints each cell's per-device FLOPs, bytes,
link bytes, resident and temporary bytes and its roofline bottleneck on
the H100 (``dryrun_lib.HW``), and writes one JSON per cell under --out.
Device-free by design: nothing is allocated and nothing launches, and
nothing is set in the environment.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --multi-pod --quant binary_weights
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch import configs
from repro_torch.launch import dryrun_lib as lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--pods", type=int, default=0,
                    help="N×16×16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "binary", "binary_weights"])
    ap.add_argument("--microbatches", type=int, default=0,
                    help="grad-accum microbatches for train cells "
                         "(0 → per-cell default)")
    ap.add_argument("--out", default="experiments/cells_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch in archs:
        skipped = configs.get_skipped_shapes(arch)
        for shape in lib.cells_for(arch):
            if args.shape != "all" and shape.name != args.shape:
                continue
            for mp in meshes:
                n_pods = args.pods or (2 if mp else 1)
                mesh_name = f"{n_pods}x16x16" if n_pods > 1 else "16x16"
                fname = (f"{args.out}/{arch}__{shape.name}__{mesh_name}"
                         f"__{args.quant}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip] {fname}")
                    continue
                res = lib.run_cell(arch, shape, multi_pod=mp,
                                   quant=args.quant,
                                   microbatches=args.microbatches,
                                   pods=args.pods)
                lib.save_result(res, args.out)
                if res.ok:
                    print(f"[ok]   {arch:22s} {shape.name:12s} {mesh_name:8s}"
                          f" trace={res.compile_s:6.1f}s"
                          f" flops/dev={res.hlo_flops:.3e}"
                          f" bytes/dev={res.hlo_bytes:.3e}"
                          f" link/dev={res.coll_link_bytes:.3e}"
                          f" args={res.arg_bytes/1e9:.2f}GB"
                          f" temp={res.temp_bytes/1e9:.2f}GB"
                          f" fits={res.fits}"
                          f" bottleneck={res.bottleneck}")
                else:
                    n_fail += 1
                    print(f"[FAIL] {arch} {shape.name} {mesh_name}: "
                          f"{res.error}", file=sys.stderr)
        for sname, why in skipped.items():
            if args.shape in ("all", sname):
                print(f"[skipped-by-design] {arch} {sname}: {why}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
