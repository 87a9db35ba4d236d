"""Sharding rules: parameter / activation / cache partition specs for the
production meshes (counterpart of ``repro/parallel/sharding.py``; DP over
("pod", "data"); TP / EP / SP over "model").

Rules are path-regex driven over the parameter tree (the port's dict
keys joined by "/", as ``train/tree.py::leaves_with_path`` gives them,
which is the reference's ``_path_str``), mirroring how production
frameworks (MaxText / T5X) map logical axes:

    embedding (V, D)                → shard D ("model")   (SP-friendly gather)
    lm head (D, V)                  → shard V
    attn wq/wk/wv, mlp wi/wg, MLA
    up-projections, ssm in_proj     → shard output axis  (column parallel)
    attn wo, mlp wo, out_proj       → shard input axis   (row parallel)
    MoE expert stacks (E, ·, ·)     → shard E            (expert parallel)
    router / norms / small vectors  → replicated

Stacked-layer leading axes are padded with None automatically: rules
address *trailing* dimensions.

A spec is a plain tuple with one entry per leading dimension: None, an
axis name or a tuple of two or more names, so it compares equal to
``tuple(P)`` of the reference's ``PartitionSpec``; ``P()`` (the empty tuple) is
replicated. A spec tree has the structure of the tree it describes, a
spec where that tree has a leaf. There is no ``NamedSharding`` in torch:
``local_shape`` / ``local_bytes`` give the per-device shard a spec
places, which is what the dry run reads resident bytes through.
"""
from __future__ import annotations

import math
import re

from repro_torch.launch.mesh import dp_axes
from repro_torch.train.tree import (leaves_with_path, tree_leaves, tree_map,
                                    tree_unflatten)

# (path_regex, axis_from_end) — first match wins. axis_from_end counts the
# dimension (from the right, 1-based) that gets the "model" axis.
_RULES: list[tuple[str, int]] = [
    (r"embed/embedding", 1),            # (V, D): shard D
    (r"head/w$", 1),                    # (D, V): shard V
    (r"experts/(wi|wg|wo)(/w_packed)?$", 3),   # (E, din, dout): shard E
    (r"channel_mix/wv/w$", 2),          # (F, D): row-parallel
    (r"(wo|out_proj)/w$", 2),           # (F|H·hd, D): row-parallel
    (r"(wq|wk|wv|wg|wi|wr|wq_a|wq_b|wkv_a|wk_b|wv_b|in_proj|vision_proj|"
     r"audio_proj)/w$", 1),             # column-parallel
    (r"/w_packed$", 2),                 # packed (out, in/32): shard out
    (r"/alpha$", 1),                    # packed per-out-channel scale
    (r"(wa|wb)$", 0),                   # rwkv decay lora: replicated
]


def P(*parts) -> tuple:
    """A partition spec: ``parts`` as a tuple (``P()`` is replicated), a
    one-name tuple entry written as that name, as JAX's ``PartitionSpec``
    normalizes it."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over the leaves of ``tree``, in its structure."""
    return tree_unflatten(tree, [fn(p, leaf)
                                 for p, leaf in leaves_with_path(tree)])


def _dp(mesh) -> tuple[tuple[str, ...], int]:
    dp = dp_axes(mesh)
    return dp, math.prod(mesh.shape[a] for a in dp)


def spec_for(path_s: str, ndim: int, shape, model_size: int,
             dp: tuple[str, ...] = (), dp_size: int = 1,
             fsdp_min_size: int = 1 << 20) -> tuple:
    """TP spec from the rule table + FSDP over the DP axes.

    FSDP: after the "model" axis is placed, large tensors additionally shard
    their largest remaining divisible dim over the DP axes (ZeRO-3 — without
    it the 236B cells cannot fit: params + AdamW ≈ 2.8 TB).
    """
    spec = [None] * ndim
    for rx, axis_from_end in _RULES:
        if re.search(rx, path_s):
            if axis_from_end == 0:
                return P()
            ax = ndim - axis_from_end
            if 0 <= ax and shape[ax] % model_size == 0:
                spec[ax] = "model"
            break
    if dp_size > 1 and math.prod(shape) >= fsdp_min_size:
        cands = [i for i in range(ndim)
                 if spec[i] is None and shape[i] % dp_size == 0]
        if cands:
            ax = max(cands, key=lambda i: shape[i])
            spec[ax] = dp if len(dp) > 1 else dp[0]
    if all(s is None for s in spec):
        return P()
    return P(*spec)


def param_specs(params_tree, mesh, *, fsdp: bool = True):
    """Spec tree for a (possibly fake) parameter tree."""
    msize = mesh.shape["model"]
    dp, dsize = _dp(mesh) if fsdp else ((), 1)
    return _map_with_path(
        lambda path, leaf: spec_for(path, leaf.ndim, tuple(leaf.shape),
                                    msize, dp, dsize), params_tree)


# ---------------------------------------------------------------------------
# serving (weight-stationary) specs
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (None leaves hold none)."""
    return sum(math.prod(leaf.shape) * leaf.dtype.itemsize
               for leaf in tree_leaves(tree) if leaf is not None)


def serving_param_specs(params_tree, mesh, *, hbm_budget: float = 12e9):
    """Weight-stationary decode specs.

    Training specs are wrong for serving: ZeRO-3 re-gathers every weight
    every step, which at batch ≤ 128 decode dwarfs the compute. Serving
    keeps weights TP-sharded over "model" and REPLICATED over the DP axes.
    Only when that does not fit the HBM budget (deepseek-v2-236b in bf16)
    does FSDP stay on as the capacity fallback. The budget is the
    reference's, kept as is.
    """
    per_chip = tree_bytes(params_tree) / mesh.shape["model"]
    return param_specs(params_tree, mesh, fsdp=per_chip > hbm_budget)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_spec(mesh, batch_size: int) -> tuple:
    """Shard the global batch over the DP axes when divisible."""
    dp, n = _dp(mesh)
    if batch_size % n == 0:
        return P(dp)
    return P()     # e.g. long_500k batch=1 → replicate batch


def data_specs(mesh, batch: int, tree):
    """Spec tree for an input batch (None leaves stay None): dim 0 (the
    global batch) shards over the DP axes; other dims replicated."""
    bspec = batch_spec(mesh, batch)

    def f(leaf):
        if leaf is None:
            return None
        spec = [None] * leaf.ndim
        if leaf.ndim and leaf.shape[0] == batch and bspec != P():
            spec[0] = bspec[0]
        return P(*spec)
    return tree_map(f, tree)


def cache_spec(shape: tuple[int, ...], mesh, batch: int) -> tuple:
    """KV-cache / recurrent-state spec.

    Heuristic over trailing dims: shard the *batch* dim over DP when
    divisible; shard the largest divisible non-batch dim over "model" (for
    KV caches the sequence: attention stays local per shard, where
    sharding heads would all-gather the whole cache every layer); shard
    the sequence dim over DP when the batch is not shardable (SP — the
    long_500k B=1 case). Leading stacked-layer dims replicate.
    """
    msize = mesh.shape["model"]
    dp, dsize = _dp(mesh)
    spec = [None] * len(shape)
    used_dp = False
    # the batch dim: the first dim equal to batch (after the layer stack)
    for i, d in enumerate(shape):
        if d == batch and i <= 1:
            if batch % dsize == 0:
                spec[i] = dp if len(dp) > 1 else dp[0]
                used_dp = True
            batch_dim = i
            break
    else:
        batch_dim = -1
    cands = [i for i in range(len(shape))
             if i != batch_dim and spec[i] is None
             and shape[i] % msize == 0 and shape[i] >= msize]
    if cands:
        ax = max(cands, key=lambda i: shape[i])
        if not used_dp and dsize > 1 and shape[ax] % (msize * dsize) == 0 \
                and shape[ax] >= 4096:
            # B=1 long-context: the sequence takes ALL axes (full SP)
            spec[ax] = (*dp, "model")
            used_dp = True
        else:
            spec[ax] = "model"
    # SP fallback: a long sequence dim takes the DP axes if batch couldn't
    if not used_dp and dsize > 1:
        for i, d in enumerate(shape):
            if spec[i] is None and i != batch_dim and d % dsize == 0 \
                    and d >= 4096:
                spec[i] = dp if len(dp) > 1 else dp[0]
                break
    return P(*spec)


def state_specs(state_tree, mesh, batch: int):
    """Spec tree for a serving state (caches, recurrent states, lengths):
    ``cache_spec`` per leaf, scalars replicated, None leaves None."""
    def f(leaf):
        if leaf is None:
            return None
        if leaf.ndim == 0:
            return P()
        return cache_spec(tuple(leaf.shape), mesh, batch)
    return tree_map(f, state_tree)


# ---------------------------------------------------------------------------
# per-device shards
# ---------------------------------------------------------------------------

def _axis_size(entry, mesh) -> int:
    """Devices one spec entry splits its dimension over (None: 1)."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The per-device shard of a leaf of ``shape`` placed by ``spec`` on
    ``mesh``: each sharded dimension split over its axes, rounded up (a
    ragged last shard is padded, as XLA pads it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // _axis_size(e, mesh)) for d, e in zip(shape, spec))


def leaves_with_specs(tree, specs) -> list[tuple[str, object, tuple]]:
    """[(path, leaf, spec)] of every tensor leaf of ``tree`` under the
    spec tree ``specs``."""
    flat = []
    tree_map(lambda leaf, spec: flat.append(spec), tree, specs)
    return [(path, leaf, spec)
            for (path, leaf), spec in zip(leaves_with_path(tree), flat)
            if leaf is not None]


def local_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under the spec tree ``specs``."""
    return sum(math.prod(local_shape(tuple(leaf.shape), spec, mesh))
               * leaf.dtype.itemsize
               for _, leaf, spec in leaves_with_specs(tree, specs))
