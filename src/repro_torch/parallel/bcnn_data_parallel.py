"""Data-parallel bulk forward of the paper's BCNN (counterpart of
``repro/parallel/bcnn_data_parallel.py``).

The paper's second Fig. 7 claim (§6.3) is the large-batch scenario: on
"static data in large batch sizes" the accelerator matches a Titan X.
One stage pipeline processes one micro-batch per tick; the second scaling
axis is data parallelism: replicate the whole packed network per device
and split the batch. Per-image results are independent, so no collective
ever crosses shards and the sharded forward is bit-exact with the
sequential one by construction. With ``n_stages > 1`` each shard owns a
column of stage devices running the stage pipeline
(``parallel/bcnn_pipeline.py::PipelinedForward``): the 2-D data × stage
plan.

A list of torch devices takes the place of the reference's JAX mesh:
shard s runs on ``devices[s]`` (column s on ``devices[s·n_stages + j]``,
cycled), and a list may name one device several times, putting shards
side by side, each on its own stream.

**One capture per plan.** A batch of any size N runs in chunks of
``data_shards × micro_batch`` images, the ragged tail padded with zero
rows and sliced off again, so every shard (or every stage of every
column) sees one shape and holds one CUDA graph: ``cache_size`` stays 1
for every batch size and swap. The logits are gathered on ``devices[0]``.

Served through ``serve/bcnn_engine.py::BCNNEngine.classify_batch`` when
the engine is built with ``from_packed(data_shards=...)``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import bcnn
from repro_torch.core import execution_plan as xplan
from repro_torch.parallel.bcnn_pipeline import (PipelinedForward, StagePlan,
                                                on_stream, ordered, pad_rows,
                                                plan_bcnn_stages,
                                                resolve_devices)


class DeploymentPlan(NamedTuple):
    """The 2-D (data × stage) layout of a sharded forward.

    ``chunk = data_shards × micro_batch`` is the one batch shape a call
    runs at; ``stage_plan`` is the Table 2 cost-balanced layer partition
    of each shard column (the trivial single-stage plan when
    ``n_stages == 1``)."""
    data_shards: int
    n_stages: int
    micro_batch: int
    chunk: int
    stage_plan: StagePlan
    conv_fusion: bool = False
    fused_groups: tuple = ()   # per stage: the plan_layer_groups partition

    def describe(self) -> dict:
        """JSON-ready plan metadata (the reference's keys):
        ``conv_fusion`` / ``fused_groups`` record the fusion plan, one
        layer-group partition per stage."""
        return {"data_shards": self.data_shards,
                "n_stages": self.n_stages,
                "micro_batch": self.micro_batch,
                "chunk": self.chunk,
                "stage_bounds": list(self.stage_plan.bounds),
                "conv_fusion": bool(self.conv_fusion),
                "fused_groups": [[list(g) for g in stage]
                                 for stage in self.fused_groups]}


class ShardedForward:
    """Callable: (N, 32, 32, 3) images → (N, 10) logits, batch-sharded.

    Built by ``make_sharded_forward``. Any N (0 and N < chunk included)
    runs in ``plan.chunk``-image chunks; each shard takes its
    ``micro_batch`` rows of every chunk. With ``n_stages == 1`` a shard is
    a ``core/bcnn.py::PackedForward`` on its own device (one CUDA graph at
    ``(micro_batch, 32, 32, 3)``); with ``n_stages > 1`` a
    ``PipelinedForward`` column. A call orders every shard's streams
    after the caller's current stream and the caller after all of them;
    between those, the shards' streams run side by side. One caller at a
    time.
    """

    def __init__(self, packed: bcnn.BCNNPacked, devices: Sequence,
                 data_shards: int, micro_batch: int, *, n_stages: int = 1,
                 path: str = "auto", conv_strategy: str | None = None,
                 conv_fusion: bool | None = None,
                 plan: "xplan.ExecutionPlan | None" = None):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        devices = resolve_devices(devices)
        if data_shards > len(devices):
            raise ValueError(f"data mesh needs {data_shards} devices, have "
                             f"{len(devices)}")
        if plan is None:
            plan = xplan.build_plan(packed, path=path,
                                    conv_strategy=conv_strategy,
                                    conv_fusion=conv_fusion,
                                    device=devices[0])
        self.exec_plan = plan           # the ExecutionPlan (kernel choices)
        stage_plan = plan_bcnn_stages(n_stages)
        self.plan = DeploymentPlan(
            data_shards=data_shards, n_stages=n_stages,
            micro_batch=micro_batch, chunk=data_shards * micro_batch,
            stage_plan=stage_plan, conv_fusion=plan.conv_fusion,
            fused_groups=tuple(
                bcnn.plan_layer_groups(stage_plan.bounds[s],
                                       stage_plan.bounds[s + 1],
                                       conv_fusion=plan.conv_fusion)
                for s in range(n_stages)))
        self._n_classes = packed.fc3_w_words.shape[0]
        self.devices = tuple(devices)
        self.device = self.devices[0]
        if n_stages == 1:
            self._shards = tuple(
                bcnn.PackedForward(packed, plan=plan, device=devices[s])
                for s in range(data_shards))
            self.streams = tuple(sh.stream for sh in self._shards
                                 if sh.stream is not None)
        else:
            self._shards = tuple(
                PipelinedForward(
                    packed, stage_plan,
                    [devices[(s * n_stages + j) % len(devices)]
                     for j in range(n_stages)],
                    micro_batch, plan=plan)
                for s in range(data_shards))
            self.streams = tuple(st for col in self._shards
                                 for st in col.streams)
        self._closed = False

    @property
    def data_shards(self) -> int:
        return self.plan.data_shards

    @property
    def packed(self) -> bcnn.BCNNPacked:
        """The packed net being served (shard 0's owned copy; every shard
        holds the same)."""
        self._check_open()
        return self._shards[0].packed

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        self._check_open()
        n = x01.shape[0]
        if n == 0:          # empty batch → empty logits, nothing runs
            return torch.zeros((0, self._n_classes), dtype=torch.float32,
                               device=self.device)
        chunk, mb = self.plan.chunk, self.plan.micro_batch
        rows = -(-n // chunk) * chunk
        x = pad_rows(x01.to(self.device), rows)             # ragged tail
        out = torch.empty((rows, self._n_classes), dtype=torch.float32,
                          device=self.device)
        with ordered(self.device, self.streams):
            for c in range(0, rows, chunk):
                for s, shard in enumerate(self._shards):
                    lo = c + s * mb
                    if isinstance(shard, PipelinedForward):
                        shard._stream(x[lo:lo + mb], out[lo:lo + mb])
                    else:
                        with on_stream(shard.stream):
                            out[lo:lo + mb].copy_(shard._run(x[lo:lo + mb]))
        return out[:n]

    # ------------------------------------------------------------ contracts
    def swap(self, new_packed: bcnn.BCNNPacked) -> None:
        """Copy ``new_packed``'s weights into every shard (or shard
        column) in place; no new capture (``core/bcnn.py::
        assert_swap_compatible`` first)."""
        bcnn.assert_swap_compatible(self.packed, new_packed)
        for shard in self._shards:
            shard.swap(new_packed)

    def cache_size(self) -> int:
        """The most CUDA graphs any shard or stage holds (on the CPU: input
        shapes seen): 0 before the first call, then 1 per (shards,
        stages, micro_batch) plan for every batch size and ``swap``."""
        return max(shard.cache_size() for shard in self._shards)

    def close(self) -> None:
        """Free every shard's graphs, weights and streams; ``cache_size``
        still answers."""
        self._closed = True
        for shard in self._shards:
            shard.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("this ShardedForward was closed")


def make_sharded_forward(packed: bcnn.BCNNPacked, *,
                         data_shards: int | None = None,
                         micro_batch: int = 8, n_stages: int = 1,
                         devices=None, path: str = "auto",
                         conv_strategy: str | None = None,
                         conv_fusion: bool | None = None,
                         plan: "xplan.ExecutionPlan | None" = None
                         ) -> ShardedForward:
    """A batch-sharded deployment forward over ``devices`` (None: every
    CUDA device, raising when there is none; a list may repeat a device,
    e.g. ``['cpu'] * 2`` for the plain PyTorch path).

    * ``data_shards`` — default ``len(devices) // n_stages`` (at least 1);
      more shards than devices raises.
    * ``micro_batch`` — images per shard per chunk; a call's one shape is
      ``data_shards × micro_batch``.
    * ``n_stages`` — stages per shard column (1 = the whole network per
      device), planned by ``plan_bcnn_stages``; the grid is
      ``devices`` flattened shard-major, stage-minor, cycled.

    Bit-exact with ``forward_packed`` for any batch size, one capture
    per shard or stage."""
    if not 1 <= n_stages <= bcnn.N_LAYERS:
        raise ValueError(f"n_stages must be in 1..{bcnn.N_LAYERS}, "
                         f"got {n_stages}")
    if data_shards is not None and data_shards < 1:
        raise ValueError(f"data_shards must be >= 1, got {data_shards}")
    devices = resolve_devices(devices)
    if data_shards is None:
        data_shards = max(1, len(devices) // n_stages)
    return ShardedForward(packed, devices, data_shards, micro_batch,
                          n_stages=n_stages, path=path,
                          conv_strategy=conv_strategy,
                          conv_fusion=conv_fusion, plan=plan)
