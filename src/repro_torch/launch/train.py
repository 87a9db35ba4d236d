"""LM training driver (counterpart of ``repro/launch/train.py``).

Trains any architecture of ``configs.ARCH_NAMES`` through
``train/train_loop.py`` on ``--device`` (default the GPU; it raises when
there is none, and runs the CPU only when asked). Fault tolerance in the
loop:

* step-atomic checkpoints of the whole ``TrainState`` every
  ``--ckpt-every`` steps (``train/checkpoint.py``, the reference's
  on-disk format, so a checkpoint crosses packages both ways);
* ``--resume`` restores the newest checkpoint (parameters, optimizer,
  error feedback, step) and the data pipeline regenerates exactly the
  remaining batches (deterministic (seed, step, shard) keying);
* simulated fault injection (``--crash-at``) for the restart test;
* ``--exact-numerics`` (on the card): TF32 off and deterministic
  algorithms (``train/bcnn_train.py::exact_numerics``), so a crashed and
  resumed run ends bitwise equal to a straight one.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir build/lm_ck \\
        --ckpt-every 20
    # plain PyTorch on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch yi-6b --smoke --steps 4 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch import configs
from repro_torch.core.execution_plan import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop
from repro_torch.train.bcnn_train import SimulatedCrash, exact_numerics


def frontend_shape(cfg) -> tuple[int, int] | None:
    """The stub frontend's (positions, d_model) a batch carries: the vlm
    family's patch embeddings, the audio family's frames, else None."""
    if cfg.family == "vlm":
        return cfg.frontend_seq, cfg.d_model
    if cfg.family == "audio":
        return cfg.encoder_seq, cfg.d_model
    return None


def train(cfg, *, steps: int, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, microbatches: int = 1,
          compress_grads: bool = False, ckpt_dir: str = "",
          ckpt_every: int = 50, keep: int = 3, resume: bool = False,
          crash_at: int = -1, seed: int = 0, log_every: int = 10,
          device="cuda", exact: bool = False, verbose: bool = True):
    """Train ``cfg`` for ``steps`` steps → (final ``TrainState``, info:
    ``losses`` {step: loss}, ``start_step``, ``seconds``). Parameters are
    drawn from a generator seeded ``seed`` on ``device``; batches are
    ``SyntheticLM(seed=seed)``'s. Raises ``SimulatedCrash`` after step
    ``crash_at`` (when >= 0). ``exact`` runs the steps under
    ``exact_numerics``."""
    device = resolve_device(device)
    adamw = opt_lib.AdamW(
        lr=lr, clip_latent_unit=cfg.quant in ("binary", "binary_weights"))
    step_fn = train_loop.make_train_step(cfg, adamw,
                                         microbatches=microbatches,
                                         compress_grads=compress_grads)
    gen = torch.Generator(device=device).manual_seed(seed)
    start = 0
    if resume and ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
        # the template gives the structure only: its leaves live on "meta"
        like = train_loop.init_train_state(cfg, gen, adamw, compress_grads,
                                           device="meta")
        state, start = ckpt_lib.restore(ckpt_dir, like, device=device)
        if verbose:
            print(f"[resume] restored step {start} from {ckpt_dir}")
    else:
        state = train_loop.init_train_state(cfg, gen, adamw, compress_grads,
                                            device=device)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                       frontend=frontend_shape(cfg))
    losses = {}
    t0 = time.time()
    tokens_done = 0
    with exact_numerics() if exact else contextlib.nullcontext():
        for step in range(start, steps):
            state, metrics = step_fn(state, data.batch(step))
            losses[step] = float(metrics["loss"])
            tokens_done += batch * seq
            if verbose and ((step + 1) % log_every == 0
                            or step + 1 == steps):
                dt = time.time() - t0
                print(f"step {step + 1:5d}  loss={losses[step]:.4f}  "
                      f"nll={float(metrics['nll']):.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}  "
                      f"tok/s={tokens_done / dt:,.0f}")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                path = ckpt_lib.save(ckpt_dir, step + 1, state, keep=keep)
                if verbose:
                    print(f"[ckpt] {path}")
            if crash_at >= 0 and step + 1 >= crash_at:
                raise SimulatedCrash(f"[crash-at] simulated fault after "
                                     f"step {step + 1}")
    return state, {"losses": losses, "start_step": start,
                   "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--quant", default="none",
                    choices=["none", "binary", "binary_weights"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="1-bit gradient compression w/ error feedback")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="raise after N steps (restart testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--exact-numerics", action="store_true",
                    help="TF32 off and deterministic algorithms, so a "
                         "resumed run is bitwise equal to a straight one")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke, quant=args.quant)
    try:
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, microbatches=args.microbatches,
              compress_grads=args.compress_grads, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              crash_at=args.crash_at, seed=args.seed,
              log_every=args.log_every, device=args.device,
              exact=args.exact_numerics)
    except SimulatedCrash as e:
        raise SystemExit(str(e)) from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
