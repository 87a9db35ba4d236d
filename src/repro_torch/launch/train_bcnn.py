"""BCNN training entry point: the trained-artifact life cycle from the
command line (counterpart of ``repro/launch/train_bcnn.py``).

Runs the restartable trainer (``train/bcnn_train.py``) over the paper's
9-layer CIFAR-10 BCNN on ``--device`` (default the GPU; it raises when
there is none), checks the fold (the deployment forward through the hand
kernels vs the training-graph oracle, ``report_eval``'s 0.97 gate), and
optionally exports the packed net as a deployment artifact
(``core/bcnn_artifact.py``) that ``launch/serve_bcnn.py --artifact``
serves.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train_bcnn --steps 300 \\
        --ckpt-dir build/bcnn_ck --ckpt-every 50
    # kill it mid-run (or --crash-at 120), then continue bitwise exactly:
    PYTHONPATH=src python -m repro_torch.launch.train_bcnn --steps 300 \\
        --ckpt-dir build/bcnn_ck --ckpt-every 50 --resume
    # export the deployment artifact and serve it:
    PYTHONPATH=src python -m repro_torch.launch.train_bcnn --steps 60 \\
        --export-artifact build/bcnn_art
    PYTHONPATH=src python -m repro_torch.launch.serve_bcnn \\
        --artifact build/bcnn_art --requests 16
    # plain PyTorch on the CPU, a few steps:
    PYTHONPATH=src python -m repro_torch.launch.train_bcnn --device cpu \\
        --steps 4 --batch 16 --eval-batches 1
"""
from __future__ import annotations

import argparse

from repro_torch.configs import bcnn_cifar10 as pc
from repro_torch.core import bcnn, bcnn_artifact
from repro_torch.train import bcnn_train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=pc.TRAIN_STEPS)
    ap.add_argument("--batch", type=int, default=pc.TRAIN_BATCH)
    ap.add_argument("--lr", type=float, default=pc.TRAIN_LR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="step-atomic checkpoint directory "
                         "(train/checkpoint.py); empty = no checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=pc.TRAIN_CKPT_EVERY)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint under --ckpt-dir "
                         "and continue bitwise exactly")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a fault after N steps (restart testing)")
    ap.add_argument("--export-artifact", default="", metavar="DIR",
                    help="fold the trained net and write the deployment "
                         "artifact (core/bcnn_artifact.py)")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    try:
        state, info = bcnn_train.train(
            steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed,
            ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
            resume=args.resume,
            crash_at=args.crash_at if args.crash_at >= 0 else None,
            log_every=args.log_every, device=args.device)
    except bcnn_train.SimulatedCrash as e:
        raise SystemExit(f"[crash-at] {e}")

    ev = bcnn_train.evaluate(state.params, batch=args.batch, seed=args.seed,
                             n_batches=args.eval_batches)
    bcnn_train.report_eval(ev)

    if args.export_artifact:
        losses = info["losses"]
        mpath = bcnn_artifact.save_packed(
            args.export_artifact, bcnn.fold_model(state.params),
            provenance={"trainer": "train/bcnn_train.py::train",
                        "steps": args.steps, "batch": args.batch,
                        "lr": args.lr, "seed": args.seed,
                        "device": args.device,
                        "final_loss": losses[max(losses)] if losses
                        else None,
                        "eval": ev})
        print(f"[artifact] {mpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
