"""The LM zoo's train and serve steps (counterpart of
``repro/train/train_loop.py``).

train_step = autograd of ``models/transformer.py::loss_fn`` → (optional
1-bit gradient compression with error feedback) → AdamW → a new
``TrainState``. Eager PyTorch: the reference jit-compiles the same
composition.

* Under autograd the zoo's attention is the blockwise plain version on
  every device (``kernels/flash_attention.py::autograd_records``): K7
  has no backward, so a train step launches no K7.
* Gradient accumulation over ``microbatches``: the batch is split into
  ``(mb, B / mb, ...)`` as the reference's reshape splits it, the
  gradients are summed in float32 and divided by ``mb``, and the loss
  and nll are the means over the microbatches. With one microbatch the
  gradients come in each leaf's dtype (bf16 leaves get bf16 gradients),
  as ``jax.value_and_grad`` gives them.
* ``AdamW.update`` keeps every parameter's dtype, as the reference's
  ``upd`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.execution_plan import resolve_device
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.AdamWState
    ef: Any              # EFState | None (1-bit grad compression)


def value_and_grad(cfg, params, batch: transformer.Batch):
    """(loss, nll, gradient tree) of ``loss_fn`` at ``params``: each leaf
    is a fresh leaf of the graph (the caller's tensors are not touched),
    and a leaf the loss does not reach gets a zero gradient, as JAX gives
    it."""
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, aux = transformer.loss_fn(cfg, tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), aux["nll"].detach(), tree_unflatten(params, grads)


def split_batch(batch: transformer.Batch, n: int) -> list:
    """The ``n`` microbatches of ``batch``: rows [i·B/n, (i+1)·B/n) each,
    the reference's ``reshape(n, B // n, ...)``."""
    rows = batch.tokens.shape[0]
    if rows % n:
        raise ValueError(f"batch {rows} is not a multiple of "
                         f"microbatches {n}")
    m = rows // n
    return [transformer.Batch(*(None if a is None else a[i * m:(i + 1) * m]
                                for a in batch)) for i in range(n)]


def make_train_step(cfg, adamw: opt_lib.AdamW, *, microbatches: int = 1,
                    compress_grads: bool = False, keep_grads: bool = False):
    """Returns ``train_step(state, batch) → (state, metrics)``, metrics
    ``loss``, ``nll`` and ``grad_norm`` as 0-d tensors on the state's
    device. The batch's tensors move to the parameters' device. With
    ``keep_grads`` the metrics also hold ``grads``, the gradient tree
    before compression (for checks against another device or package)."""

    def train_step(state: TrainState, batch: transformer.Batch):
        device = tree_leaves(state.params)[0].device
        batch = transformer.Batch(*(None if a is None else a.to(device)
                                    for a in batch))
        if microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            ls, nlls = [], []
            for mb in split_batch(batch, microbatches):
                l, nll, g = value_and_grad(cfg, state.params, mb)
                gsum = tree_map(torch.add, gsum, g)
                ls.append(l)
                nlls.append(nll)
            grads = tree_map(lambda g: g / microbatches, gsum)
            l, nll = torch.stack(ls).mean(), torch.stack(nlls).mean()
        else:
            l, nll, grads = value_and_grad(cfg, state.params, batch)
        metrics = {"loss": l, "nll": nll}
        if keep_grads:
            metrics["grads"] = grads
        ef = state.ef
        with torch.no_grad():
            if compress_grads:
                grads, ef = opt_lib.compress_decompress(grads, ef)
            params, opt_state, gnorm = adamw.update(grads, state.opt,
                                                    state.params)
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, opt=opt_state, ef=ef), metrics

    return train_step


def init_train_state(cfg, generator: torch.Generator, adamw: opt_lib.AdamW,
                     compress_grads: bool = False,
                     device="cuda") -> TrainState:
    """Fresh parameters from ``generator`` (``transformer.init_params``)
    on ``device``, zero Adam moments and, with ``compress_grads``, zero
    error-feedback residuals. ``device`` "cuda" raises where there is no
    GPU."""
    params = transformer.init_params(cfg, generator, resolve_device(device))
    return TrainState(
        params=params,
        opt=adamw.init(params),
        ef=opt_lib.ef_init(params) if compress_grads else None)


def make_serve_step(cfg):
    """Returns ``serve_step(params, state, tokens, frontend)``: one decode
    step for the whole request batch (``transformer.decode_step``)."""

    def serve_step(params, state, tokens, frontend=None):
        return transformer.decode_step(cfg, params, state, tokens, frontend)

    return serve_step
