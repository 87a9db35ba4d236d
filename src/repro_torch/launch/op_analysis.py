"""Op-level roofline analysis of the port's real program (counterpart of
``repro/launch/hlo_analysis.py``, renamed: there is no HLO).

The reference reads costs from the optimized per-chip HLO of a lowered
cell. The port has no compiler pass to read, so ``OpCounter``, a
``TorchDispatchMode``, watches every aten op the program runs. The
program runs on fake tensors (``torch._subclasses.fake_tensor``) on the
CPU device, so nothing is allocated and nothing launches: every kernel
wrapper takes its plain version, whose ops are what is counted.

Cost model:

* FLOPs: the matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions; ``matmul`` and ``einsum`` reach them) as
  ``torch.utils.flop_counter`` counts them, 2·M·N·K. Elementwise work is
  not counted.
* HBM bytes: operand + result bytes of every op that computes (view and
  metadata ops move none; an in-place result counts once, as its
  operand; a gather from a table reads the rows it returns, not the
  table). Eager PyTorch fuses nothing, so this is the reference's
  unfused upper bound.
* Live bytes: the results still referenced (by the program or by
  autograd), at their largest: the dry run's ``temp_bytes``.
* Trip counts: layers of one kind cost the same. The dry run
  (``launch/dryrun_lib.py``) traces the cell's program cut to one layer
  of each stack kind and, in turn, with one more layer of one kind; the
  difference is one layer's cost, multiplied by the count of the layers
  left out: the counterpart of the reference's ``known_trip_count``
  multiplier.
* Per device: the trace runs at global shapes. Bytes of a parameter or
  state leaf count at the share one device holds of it (the leaf's spec:
  a weight gathered by FSDP counts at its model-axis shard, a cache or an
  optimizer moment at its whole local shard); every other tensor and
  every FLOP at 1 / (batch shards · model shards), the work split over
  the batch (when it divides the DP axes, as ``batch_spec`` splits it)
  and the model axis.
* Collectives: there is no SPMD pass to read them from, so
  ``collective_link_bytes`` models them from the specs, each priced by
  ``link_bytes_for``'s ring model:
  - train: the FSDP all-gather of every weight sharded over the DP axes
    (forward, and again under remat), a reduce-scatter of its gradient,
    and an all-reduce of the gradient of every weight the DP axes
    replicate, each once per microbatch;
  - TP: an all-reduce of the output of each row-parallel product over
    the model axis (counted in the trace at its local bytes), in the
    forward, in each recompute, and once more in the backward of a train
    step;
  - EP: an all-to-all of the routed tokens into the expert products and
    one of their results back, forward and (train) backward;
  - a serving cell whose weights stay FSDP-sharded (the HBM fallback)
    all-gathers every such weight every step.
"""
from __future__ import annotations

import contextlib
import math
import re
import weakref
from dataclasses import dataclass, fields

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel.sharding import leaves_with_specs, local_shape

_ALLOCS = {"empty", "empty_strided", "empty_like", "new_empty",
           "new_empty_strided"}
_GATHERS = {"embedding", "index_select", "gather", "index"}
_SCATTERS = {"index_put_", "index_put", "scatter_", "index_copy_",
             "index_add_"}
_ROW_PARALLEL = re.compile(r"(channel_mix/wv|wo|out_proj)/w$")
_EXPERT_IN = re.compile(r"experts/wi(/w_packed)?$")
_EXPERT_OUT = re.compile(r"experts/wo(/w_packed)?$")


def link_bytes_for(op_name: str, nbytes: int, group: int) -> float:
    """Per-device link traffic of one collective under a ring schedule:
    all-gather (n−1)/n · out, all-reduce 2·(n−1)/n · out (reduce-scatter
    + all-gather), reduce-scatter (n−1) · out (the input, n · out, streams
    through), all-to-all (n−1)/n · out, collective-permute out."""
    n = max(group, 2)
    if op_name.startswith("all-gather"):
        return nbytes * (n - 1) / n
    if op_name.startswith("all-reduce"):
        return 2 * nbytes * (n - 1) / n
    if op_name.startswith("reduce-scatter"):
        return nbytes * (n - 1)
    if op_name.startswith("all-to-all"):
        return nbytes * (n - 1) / n
    return float(nbytes)       # collective-permute


@dataclass
class Costs:
    """Per-device costs of a traced program (see the module docstring)."""
    flops: float = 0.0
    bytes: float = 0.0
    live_bytes: float = 0.0      # the largest live set
    ops: int = 0
    # bytes and count of the row-parallel products' outputs (TP) and of
    # the routed tokens into and out of the experts (EP), in the forward
    # and recomputed in a backward
    tp_fwd: float = 0.0
    tp_remat: float = 0.0
    ep_fwd: float = 0.0
    ep_remat: float = 0.0
    n_tp_fwd: int = 0
    n_tp_remat: int = 0
    n_ep_fwd: int = 0
    n_ep_remat: int = 0

    def plus(self, other: "Costs", times: float = 1.0) -> "Costs":
        """self + times · other, field by field (``live_bytes`` too: a
        per-layer growth of the live set adds up as the layers do)."""
        return Costs(*(getattr(self, f.name) + times * getattr(other, f.name)
                       for f in fields(self)))

    def minus(self, other: "Costs") -> "Costs":
        return self.plus(other, -1.0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass(frozen=True)
class Leaf:
    """What the counter knows of a parameter or state leaf: the share of
    its bytes one device reads, and its role in the collective model
    ("row", "expert_in", "expert_out" or None)."""
    share: float
    role: str | None = None


def leaf_table(tree, specs, mesh, *, gathered: bool) -> dict:
    """{storage key: ``Leaf``} for every tensor leaf of ``tree`` under the
    spec tree ``specs``. ``gathered``: the leaves are weights that FSDP
    gathers before use, so a device reads its model-axis shard; else its
    whole local shard."""
    table = {}
    for path, leaf, spec in leaves_with_specs(tree, specs):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if gathered:
            spec = tuple(e if e == "model" else None for e in spec)
        share = math.prod(local_shape(tuple(leaf.shape), spec, mesh)) / max(
            leaf.numel(), 1)
        role = None
        if leaf.ndim >= 2 and spec[-2] == "model" and _ROW_PARALLEL.search(
                path):
            role = "row"
        elif leaf.ndim >= 3 and spec[-3] == "model":
            role = ("expert_in" if _EXPERT_IN.search(path) else
                    "expert_out" if _EXPERT_OUT.search(path) else None)
        table[_key(leaf)] = Leaf(share, role)
    return table


class OpCounter(TorchDispatchMode):
    """Counts ``Costs`` of the aten ops run under it, per device.

    ``leaves``: ``leaf_table`` entries of the program's parameter and
    state leaves; ``act_share``: the share of every other tensor (and of
    the FLOPs) one device holds. Enter it inside ``FakeTensorMode``.
    """

    def __init__(self, leaves: dict | None = None, act_share: float = 1.0):
        super().__init__()
        self.leaves = leaves or {}
        self.act_share = act_share
        self.costs = Costs()
        self._refs: dict[int, int] = {}
        self._size: dict[int, int] = {}
        self._live = 0

    def _share(self, t: torch.Tensor) -> float:
        leaf = self.leaves.get(_key(t))
        return self.act_share if leaf is None else leaf.share

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._live -= self._size.pop(key)

    def _track(self, outs, in_keys: set) -> None:
        """Hold every result's storage in the live set until the last
        tensor on it is collected."""
        for t in outs:
            key = _key(t)
            if key not in self._refs:
                if key in in_keys or key in self.leaves:
                    continue
                self._refs[key] = 0
                self._size[key] = t.untyped_storage().nbytes()
                self._live += self._size[key]
            self._refs[key] += 1
            weakref.finalize(t, self._release, key)
        self.costs.live_bytes = max(self.costs.live_bytes,
                                    self._live * self.act_share)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        in_keys = {_key(t) for t in ins}
        self._track(outs, in_keys)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        name = func.overloadpacket.__name__
        if name in _ALLOCS or not (writes or any(
                _key(t) not in in_keys for t in outs)):
            return out          # a view, an allocation or metadata
        c = self.costs
        c.ops += 1
        if name in _SCATTERS:
            # an in-place write of a few rows: the rows (and their
            # indices), not the whole destination
            rows = ins[1:]
            c.bytes += _nbytes(rows[-1]) * self._share(ins[0]) + sum(
                _nbytes(t) * self._share(t) for t in rows)
            return out
        if name in _GATHERS:
            ins = ins[1:]
            c.bytes += _nbytes(outs[0]) * self._share(args[0])
        c.bytes += sum(_nbytes(t) * self._share(t) for t in ins)
        c.bytes += sum(_nbytes(t) * self._share(t) for t in outs
                       if _key(t) not in in_keys)
        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs,
                                             out_val=out) * self.act_share
            self._collectives(ins, outs)
        return out

    @contextlib.contextmanager
    def attention_as_k7(self):
        """Inside, ``kernels/ops.py::flash_attention`` (the models' no-grad
        attention, K7 on the card) counts as K7 runs, not as its plain
        version's S×S scores: 2·B·Hq·(hd + dv) FLOP per kept (query, key)
        pair (S(S+1)/2 of them when causal; 4·B·Hq·hd where v is as wide
        as q), Q, K and V read once and O written once; its result is a
        fresh (B, Hq, S, dv) tensor. Swaps the module attribute for the
        duration: one trace at a time."""
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import ops

        plain = ops.flash_attention

        def k7(q, k, v, *, causal: bool = True):
            kfa.check_inputs(q, k, v)
            kfa.check_no_grad(q, k, v)
            b, hq, s, hd = q.shape
            dv = v.shape[3]
            kept = s * (s + 1) // 2 if causal else s * s
            out = q.new_empty((b, hq, s, dv))
            c = self.costs
            c.ops += 1
            c.flops += 2 * b * hq * (hd + dv) * kept * self.act_share
            c.bytes += (_nbytes(q) + _nbytes(k) + _nbytes(v)
                        + _nbytes(out)) * self.act_share
            return out

        ops.flash_attention = k7
        try:
            yield
        finally:
            ops.flash_attention = plain

    def _collectives(self, ins, outs) -> None:
        """The TP / EP terms of a matrix product on a weight leaf read in
        its stored orientation (a forward product; in a backward pass only
        the recomputed forward reads it so)."""
        c = self.costs
        phase = "fwd" if torch._C._current_autograd_node() is None \
            else "remat"
        for t in ins:
            leaf = self.leaves.get(_key(t))
            if leaf is None or leaf.role is None or t.stride(-1) != 1:
                continue
            if leaf.role == "row":
                kind, moved = "tp", outs
            elif leaf.role == "expert_in":
                kind, moved = "ep", [a for a in ins if a is not t]
            else:
                kind, moved = "ep", outs
            nb = sum(_nbytes(a) for a in moved) * self.act_share
            setattr(c, f"{kind}_{phase}", getattr(c, f"{kind}_{phase}") + nb)
            setattr(c, f"n_{kind}_{phase}",
                    getattr(c, f"n_{kind}_{phase}") + 1)


def fsdp_link_bytes(tree, specs, mesh, dp: tuple[str, ...], *,
                    gathers: int, reductions: int) -> tuple[float, dict]:
    """Per-device link bytes of the weights' DP collectives: ``gathers``
    all-gathers of every weight sharded over the DP axes, and
    ``reductions`` reductions of its gradient: a reduce-scatter or, for a
    weight the DP axes replicate, an all-reduce. Returns (bytes, {op:
    count})."""
    n_dp = math.prod(mesh.shape[a] for a in dp)
    link, counts = 0.0, {}
    if n_dp <= 1:
        return link, counts

    def add(op: str, nbytes: int, n: int) -> None:
        nonlocal link
        if n:
            link += n * link_bytes_for(op, nbytes, n_dp)
            counts[op] = counts.get(op, 0) + n

    for _, leaf, spec in leaves_with_specs(tree, specs):
        model_only = tuple(e if e == "model" else None for e in spec)
        gathered = math.prod(local_shape(tuple(leaf.shape), model_only,
                                         mesh)) * leaf.element_size()
        if any(e not in (None, "model") for e in spec):
            local = math.prod(local_shape(tuple(leaf.shape), spec, mesh))
            add("all-gather", gathered, gathers)
            add("reduce-scatter", local * leaf.element_size(), reductions)
        else:
            add("all-reduce", gathered, reductions)
    return link, counts
