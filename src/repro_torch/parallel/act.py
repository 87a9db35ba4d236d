"""Activation sharding tags (counterpart of ``repro/parallel/act.py``).

The reference's model code may call ``constrain(x, "batch", None,
"model")`` with *logical* axis tags; inside a ``with mesh:`` block XLA's
SPMD partitioner pins the tensor to the physical axes they resolve to
(batch → ("pod", "data") on multi-pod, ("data",) on one pod). The port
runs in one process and has no SPMD partitioner to pin, so ``constrain``
and ``constrain_tree`` are the identity, as the reference's are outside
a mesh; the zoo's models call neither. ``logical_spec`` keeps the tag
resolution, for code that places tensors by hand or reports where they
would live (the dry run).
"""
from __future__ import annotations

from repro_torch.parallel.sharding import P


def _resolve(tag, names: set[str]):
    if tag is None:
        return None
    if tag == "batch":
        dp = tuple(a for a in ("pod", "data") if a in names)
        return dp if dp else None
    if tag in names:
        return tag
    return None


def logical_spec(tags, mesh) -> tuple:
    """The spec the logical ``tags`` resolve to on ``mesh``: "batch" → the
    DP axes, a mesh axis name → itself, anything else → None."""
    names = set(mesh.axis_names)
    return P(*(_resolve(t, names) for t in tags))


def constrain(x, *tags):
    """The identity (the same tensor object): one process has no SPMD
    partitioner to pin ``x`` to ``logical_spec(tags, mesh)``."""
    return x


def constrain_tree(tree, *tags):
    """The identity over a tree, as ``constrain`` is over a tensor."""
    return tree
