"""Restartable training of the paper's 9-layer CIFAR-10 BCNN (counterpart
of ``repro/train/bcnn_train.py``).

The training half of the paper's life cycle (Fig. 3): learn float latent
weights under binary constraints, so that ``core/bcnn.py::fold_model``
folds them into the packed net the serving tier runs. One eager step is
the Courbariaux/Bengio recipe:

* STE gradients through every binarize (``core/bcnn.py::loss_fn``);
* Adam on the latent weights (``train/optimizer.py::AdamW`` through
  ``make_adamw``: no weight decay, since BN statistics share the tree),
  then the [−1, 1] clip of the weight leaves only;
* the BN running statistics updated after the optimizer step
  (``update_running_stats``, unbiased batch variance).

Restartability: the whole ``BCNNTrainState`` (params, Adam moments, step
counter) checkpoints step-atomically (``train/checkpoint.py``), and batch
``s`` is a pure function of ``(seed, s)`` (``data/pipeline.py``), so a run
killed at any step and resumed from its last checkpoint ends bitwise
equal to one that never died — on the CPU and on the card. On the card
that takes ``exact_numerics``: TF32 off for cuBLAS and cuDNN (cuDNN's
default would round CONV-1's scaled weights and every gradient conv),
``torch.use_deterministic_algorithms`` (cuDNN's weight-gradient
algorithms may add with atomics) and ``CUBLAS_WORKSPACE_CONFIG``.
``train`` holds them while it runs and restores the caller's settings.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple

import torch

from repro_torch.core import bcnn, execution_plan
from repro_torch.core.binarize import clip_latent
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

MIN_FOLD_AGREEMENT = 0.97   # deployment-vs-training top-1 divergence gate


class BCNNTrainState(NamedTuple):
    """Everything a restart needs: parameters and optimizer moments (the
    Adam step counter is ``opt.step``)."""
    params: bcnn.BCNNParams
    opt: opt_lib.AdamWState


class SimulatedCrash(RuntimeError):
    """Raised by ``train(crash_at=N)`` after step N (restart testing)."""


@contextlib.contextmanager
def exact_numerics():
    """Full float32, run-to-run deterministic kernels inside the block:
    TF32 off for cuBLAS and cuDNN, cuDNN autotuning off, deterministic
    algorithms on, and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless set (it
    takes effect only if set before this process's first cuBLAS call).
    The previous settings come back on exit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved[:3]
        torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])


def make_adamw(lr: float = 2e-3) -> opt_lib.AdamW:
    """Plain Adam on the latent weights: ``weight_decay=0`` (BN statistics
    live in the same tree and must not decay), no unit clip (it belongs on
    the weight leaves only, ``clip_latent_weights``), no global-norm clip
    (early BCNN gradients have norm ≫ 1), ``b2=0.999``."""
    return opt_lib.AdamW(lr=lr, b2=0.999, weight_decay=0.0,
                         clip_latent_unit=False, grad_clip=float("inf"))


def clip_latent_weights(params: bcnn.BCNNParams) -> bcnn.BCNNParams:
    """Clip every latent weight leaf to [−1, 1], leaving BN leaves alone."""
    def clip_w(p):
        return p._replace(w=clip_latent(p.w))
    return bcnn.BCNNParams(conv1=clip_w(params.conv1),
                           convs=tuple(clip_w(p) for p in params.convs),
                           fcs=tuple(clip_w(p) for p in params.fcs))


def init_state(generator: torch.Generator,
               adamw: opt_lib.AdamW) -> BCNNTrainState:
    """Fresh state on the CPU, drawn from ``generator`` (``bcnn.init``)."""
    params = bcnn.init(generator)
    return BCNNTrainState(params=params, opt=adamw.init(params))


def state_to(state: BCNNTrainState, device) -> BCNNTrainState:
    return tree_map(lambda t: t.to(device), state)


def make_train_step(adamw: opt_lib.AdamW) -> Callable:
    """Eager ``(state, x01, labels) → (state, metrics)`` train step;
    ``metrics`` holds the ``loss`` and the global ``grad_norm`` as 0-d
    tensors on the state's device. Unused leaves (the running BN
    statistics) get zero gradients, as JAX gives them, so Adam leaves them
    unchanged."""
    def train_step(state: BCNNTrainState, x01: torch.Tensor,
                   labels: torch.Tensor):
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          state.params)
        loss, stats = bcnn.loss_fn(params, x01, labels)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        with torch.no_grad():
            new, opt, gnorm = adamw.update(grads, state.opt, state.params)
            new = bcnn.update_running_stats(
                clip_latent_weights(new),
                [(m.detach(), v.detach()) for m, v in stats])
        return (BCNNTrainState(params=new, opt=opt),
                {"loss": loss.detach(), "grad_norm": gnorm})
    return train_step


def train(*, steps: int, batch: int = 64, lr: float = 2e-3, seed: int = 0,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = False, crash_at: int | None = None,
          log_every: int = 50, verbose: bool = True, device="cuda"
          ) -> tuple[BCNNTrainState, dict]:
    """Run (or resume) the restartable BCNN training loop on ``device``
    (default the GPU; raises when there is none — pass ``device="cpu"``).

    * ``ckpt_dir``/``ckpt_every``: save the whole state step-atomically
      every ``ckpt_every`` steps (0 = never).
    * ``resume``: restore the newest checkpoint under ``ckpt_dir`` (if
      any) and continue from its step; the deterministic data stream
      regenerates the remaining batches, so the run ends bitwise equal
      to an uninterrupted one.
    * ``crash_at``: raise ``SimulatedCrash`` once ``crash_at`` steps have
      completed (after any due checkpoint).

    The initial state is drawn on the CPU from ``seed`` (the same on every
    device). Returns ``(final_state, info)``: ``info["losses"]`` maps each
    step of this run to its loss, ``info["start_step"]`` is where it
    began.
    """
    device = execution_plan.resolve_device(device)
    adamw = make_adamw(lr)
    step_fn = make_train_step(adamw)
    with exact_numerics():
        state = state_to(init_state(torch.Generator().manual_seed(seed),
                                    adamw), device)
        start = 0
        if resume and ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
            state, start = ckpt_lib.restore(ckpt_dir, state, device=device)
            if verbose:
                print(f"[resume] restored step {start} from {ckpt_dir}")
        data = SyntheticImages(global_batch=batch, seed=seed)
        losses: dict[int, float] = {}
        for s in range(start, steps):
            x, y = data.batch(s)
            state, metrics = step_fn(state, torch.from_numpy(x).to(device),
                                     torch.from_numpy(y).to(device))
            losses[s] = float(metrics["loss"])
            if verbose and ((s + 1) % log_every == 0 or s == start):
                print(f"step {s + 1:5d}  loss={losses[s]:.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}")
            if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
                path = ckpt_lib.save(ckpt_dir, s + 1, state)
                if verbose:
                    print(f"[ckpt] {path}")
            if crash_at is not None and s + 1 >= crash_at:
                raise SimulatedCrash(f"simulated fault after step {s + 1}")
    return state, {"losses": losses, "start_step": start}


@torch.no_grad()
def evaluate(params: bcnn.BCNNParams, *, batch: int = 64, seed: int = 0,
             n_batches: int = 4, conv_strategy: str | None = None,
             path: str = "auto", conv_fusion: bool | None = None) -> dict:
    """Held-out agreement of the life cycle: fold the trained params and
    compare the deployment forward (``forward_packed`` through the plan
    that ``path``/``conv_strategy``/``conv_fusion`` give on the params'
    device: the hand kernels K1–K5 on the card, "auto" = mxu; the plain
    path "xla" on the CPU) with the training-graph oracle
    (``forward_eval``) on fresh synthetic batches, drawn from steps
    10 000 + b so they never overlap the training stream.

    Returns ``{"acc_eval", "acc_packed", "agree", "n"}`` (fractions)."""
    device = params.conv1.w.device
    data = SyntheticImages(global_batch=batch, seed=seed)
    packed = bcnn.fold_model(params)
    plan = execution_plan.build_plan(packed, path=path,
                                     conv_strategy=conv_strategy,
                                     conv_fusion=conv_fusion, device=device)
    n = correct_eval = correct_packed = agree = 0
    for b in range(n_batches):
        x, y = data.batch(10_000 + b)
        xt = torch.from_numpy(x).to(device)
        pe = bcnn.forward_eval(params, xt).argmax(-1).cpu().numpy()
        pp = bcnn.forward_packed(packed, xt, plan=plan).argmax(-1)
        pp = pp.cpu().numpy()
        correct_eval += int((pe == y).sum())
        correct_packed += int((pp == y).sum())
        agree += int((pe == pp).sum())
        n += len(y)
    return {"acc_eval": correct_eval / n, "acc_packed": correct_packed / n,
            "agree": agree / n, "n": n}


def report_eval(ev: dict) -> None:
    """Print the ``evaluate`` summary and enforce the fold-fidelity gate
    (``MIN_FOLD_AGREEMENT``); raises RuntimeError below it."""
    print(f"eval accuracy   : {ev['acc_eval']:6.1%} (training graph)")
    print(f"packed accuracy : {ev['acc_packed']:6.1%} "
          f"(deployment graph: XNOR + eq.8 comparators)")
    print(f"top-1 agreement : {ev['agree']:6.1%}")
    if not ev["agree"] >= MIN_FOLD_AGREEMENT:
        raise RuntimeError(
            f"deployment path diverged from training: top-1 agreement "
            f"{ev['agree']:.3f} < {MIN_FOLD_AGREEMENT}")
