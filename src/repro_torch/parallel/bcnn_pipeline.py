"""Stage-pipelined deployment forward of the paper's BCNN (counterpart of
``repro/parallel/bcnn_pipeline.py``).

The paper's accelerator is batch-insensitive because its 9 layers are laid
out as deep pipeline stages (§4, Fig. 5/6): every conv/FC unit works on a
different image at the same instant, and eq. 12 — throughput = freq /
max(C_1..C_k) — is the steady-state law of that layout. This module is
the software form over a list of torch devices: the packed deployment
forward (``core/bcnn.py::forward_packed``) is cut into N contiguous
stages, each stage owns its weights on its device, and micro-batches
stream through the stages — while stage s works on micro-batch t, stage
s−1 already works on micro-batch t+1.

* **Stage-cost model** — per-layer binary-op counts from Table 2
  (``layer_costs``: eq. 9 ``cycle_conv`` for CONV-1..6, i·o MACs for
  FC-1..3), cut by the exact DP of the Table 3 reproduction
  (``core/throughput.py::balance_stages``) → ``plan_bcnn_stages``.
* **Boundary repacking** — stage boundaries carry bit-packed activations
  (``pack_boundary`` / ``unpack_boundary``): a conv boundary's {0,1} int8
  NHWC map is packed 32 to an int32 word along its channels, so a
  handoff moves the paper's one bit per activation.
* **``PipelinedForward``** — the same ``(N, 32, 32, 3) → (N, 10)``
  callable as ``core/bcnn.py::PackedForward``, with ``swap`` and
  ``cache_size``, so ``serve/bcnn_engine.py::BCNNEngine`` steps it
  unchanged. Each stage is a ``PackedForward`` over its layer range: owned
  weights, a pooled stream (``kernels/streams.py``), and on the card one
  CUDA graph at its fixed ``(micro_batch, …)`` boundary shape, so
  ``cache_size`` stays 1 for any batch size, occupancy and swap.

On the card the stages' graphs read and write static buffers, where the
reference's stage calls return fresh arrays. Two orderings keep a replay
from overwriting what the next stage has not read: stage s's copy of
stage s−1's output waits for the event stage s−1 records after its
replay (``ready``), and stage s−1's next replay waits for the event stage
s records once that copy is done (``taken``). The last stage copies its
output into the logits before its next replay, on its own stream.

The schedule is the inference fill/drain pipeline: with S stages and M
micro-batches a forward takes M+S−1 ticks (``schedule_stream``).
``devices=None`` means every CUDA device and raises when there is none;
the CPU runs only when the caller passes it, eager, as the plain
version the tests hold against the reference.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import bcnn, bitpack
from repro_torch.core import execution_plan as xplan
from repro_torch.core.throughput import (BCNN_CONV_LAYERS, BCNN_FC_SPECS,
                                         balance_stages, cycle_conv)
from repro_torch.parallel.pipeline import (schedule_1f1b,
                                           stage_costs_from_bounds)

LAYER_NAMES = tuple(d.name for d in BCNN_CONV_LAYERS) + ("FC 1", "FC 2",
                                                         "FC 3")

# Natural inter-layer activation forms of the packed forward (the input of
# layer i lives at boundary i; boundary 9 is the logits). Spatial dims from
# Table 2: pools after CONV-2/4/6 halve H×W. Forms (for batch B):
#   boundary 0:    (B, 32, 32, 3)  float32 image
#   boundary 1..6: (B, H, W, C)    {0,1} int8 bit map    (see _CONV_BOUNDS)
#   boundary 7..8: (B, 32)         int32 packed words
#   boundary 9:    (B, 10)         float32 logits
_CONV_BOUNDS = {1: (32, 32, 128), 2: (16, 16, 128), 3: (16, 16, 256),
                4: (8, 8, 256), 5: (8, 8, 512), 6: (4, 4, 512)}


def layer_costs() -> list[float]:
    """Per-layer op counts of the 9-layer BCNN (the C_l of eq. 12).

    CONV-1..6 use the paper's eq. 9 serial cycle count
    (WID·HEI·DEP·FW·FH·FD, Table 2/3's ``Cycle_conv``); FC-1..3 use in·out
    MACs. One XNOR+accumulate per position in both, so the units agree and
    ``balance_stages`` can cut across the conv/FC border.
    """
    return ([float(cycle_conv(d)) for d in BCNN_CONV_LAYERS]
            + [float(i * o) for i, o in BCNN_FC_SPECS])


class StagePlan(NamedTuple):
    """A cost-balanced partition of the 9 layers into pipeline stages."""
    bounds: tuple          # n_stages+1 layer boundaries (bounds[0]=0, [-1]=9)
    costs: tuple           # per-layer op counts (len 9)
    stage_costs: tuple     # per-stage summed cost (len n_stages)

    @property
    def n_stages(self) -> int:
        return len(self.bounds) - 1

    @property
    def bottleneck(self) -> float:
        """max stage cost — the eq. 12 throughput limiter C_max."""
        return max(self.stage_costs)

    @property
    def balance(self) -> float:
        """mean/max stage cost; 1.0 ⇔ perfectly equalized (§4.3 optimum)."""
        return (sum(self.stage_costs)
                / (self.n_stages * self.bottleneck))

    def stage_layers(self, s: int) -> tuple:
        """Layer names of stage ``s`` (for logs and tables)."""
        return LAYER_NAMES[self.bounds[s]:self.bounds[s + 1]]


def plan_bcnn_stages(n_stages: int) -> StagePlan:
    """Cut the BCNN's 9 layers into ``n_stages`` bottleneck-minimal stages
    (``core/throughput.py::balance_stages`` on the Table 2 op counts)."""
    if not 1 <= n_stages <= bcnn.N_LAYERS:
        raise ValueError(f"n_stages must be in 1..{bcnn.N_LAYERS}, "
                         f"got {n_stages}")
    costs = layer_costs()
    bounds = balance_stages(costs, n_stages)
    return StagePlan(bounds=tuple(bounds), costs=tuple(costs),
                     stage_costs=tuple(stage_costs_from_bounds(costs,
                                                               bounds)))


def schedule_stream(plan: StagePlan, n_micro: int) -> dict:
    """Analytic fill/drain model of the inference pipeline:
    ``parallel/pipeline.py::schedule_1f1b`` with ``fwd_bwd_mult=1`` (every
    tick is one forward; the n_micro→∞ steady rate is eq. 12's 1/C_max)."""
    return schedule_1f1b(list(plan.stage_costs), n_micro, fwd_bwd_mult=1.0)


# ---------------------------------------------------------------------------
# stage-boundary repacking: bit maps cross stages as packed words
# ---------------------------------------------------------------------------

def pack_boundary(i: int, h: torch.Tensor) -> torch.Tensor:
    """Wire format of boundary ``i``: conv boundaries (1..6) pack the {0,1}
    int8 NHWC map along its 32-aligned channels → (B, H, W, C//32) int32,
    an 8× byte shrink of the handoff; boundaries 0 (image), 7/8 (already
    words) and 9 (logits) pass through."""
    if i in _CONV_BOUNDS:
        return bitpack.pack_bits(h)
    return h


def unpack_boundary(i: int, h: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_boundary``: restore the natural per-layer form."""
    if i in _CONV_BOUNDS:
        return bitpack.unpack_bits(h, k=_CONV_BOUNDS[i][2])
    return h


def pad_rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Zero-pad dim 0 of ``x`` up to ``n_rows`` (``x`` itself when already
    there): the streaming forwards' ragged-tail contract — batches are
    padded to the fixed granule with zero rows and the results sliced
    back, so rows never mix and no new shape is ever captured."""
    if x.shape[0] == n_rows:
        return x
    return torch.cat([x, x.new_zeros((n_rows - x.shape[0],
                                      *x.shape[1:]))])


def _make_stage_fn(a: int, b: int, plan: "xplan.ExecutionPlan"):
    """``stage(packed, h)`` applying layers [a, b): unpack → layer groups →
    pack. ``plan.conv_fusion`` pairs convs within [a, b) only
    (``core/bcnn.py::plan_layer_groups(a, b)``): a stage cut is a device
    boundary, so no fused pair spans one."""
    groups = bcnn.plan_layer_groups(a, b, conv_fusion=plan.conv_fusion)

    def stage(packed: bcnn.BCNNPacked, h: torch.Tensor) -> torch.Tensor:
        h = unpack_boundary(a, h)
        for group in groups:
            h = bcnn.apply_packed_group(packed, group, h, plan=plan)
        return pack_boundary(b, h)
    return stage


def on_stream(stream):
    """Make ``stream`` (and its device) current; a no-op for None (the
    CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


@contextlib.contextmanager
def ordered(device: torch.device, streams: Sequence):
    """Inside: ``streams`` run after the work the caller (the current
    stream of ``device``) has queued; on exit the caller waits for all of
    them. A no-op on the CPU (no streams)."""
    caller = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    for s in streams:
        if s != caller:
            s.wait_stream(caller)
    yield
    for s in streams:
        if s != caller:
            caller.wait_stream(s)


def resolve_devices(devices) -> list[torch.device]:
    """``devices`` as torch devices; None → every CUDA device, which
    raises when there is none (the CPU runs only when passed)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=None means every CUDA device, but "
                "torch.cuda.is_available() is False; pass "
                "devices=['cpu'] to run the plain PyTorch path")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [xplan.resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("devices is empty")
    return devices


class _Stage(bcnn.PackedForward):
    """Layers [a, b) of the packed forward on one device: a
    ``PackedForward`` (owned weights, pooled stream, one graph per input
    shape, ``swap``, ``close``) whose function is the stage's."""

    def __init__(self, packed: bcnn.BCNNPacked, a: int, b: int, plan,
                 device: torch.device):
        super().__init__(packed, plan=plan, device=device)
        self._stage_fn = _make_stage_fn(a, b, plan)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._stage_fn(self._packed, x)


# ---------------------------------------------------------------------------
# the pipelined forward
# ---------------------------------------------------------------------------

class PipelinedForward:
    """Callable: (N, 32, 32, 3) images → (N, 10) logits, stage-pipelined.

    Built by ``make_pipelined_forward``. The batch is split into fixed
    micro-batches (the last one zero-padded, its rows sliced away again);
    micro-batch m enters stage s at tick m+s, so all stages work at once
    once the pipeline fills. Stage s runs on ``devices[s]`` (the given
    list cycled: fewer devices than stages puts stages side by side, each
    on its own stream). The logits land on ``devices[0]``.

    Every stage sees only its ``(micro_batch, …)`` boundary shape, so on
    the card each holds one CUDA graph for ANY batch size and occupancy;
    ``cache_size`` (the most any stage holds; on the CPU, input shapes
    seen) stays 1. A call orders every stage's stream after the caller's
    current stream and the caller after every stage, as
    ``PackedForward.__call__`` does. One caller at a time.
    """

    def __init__(self, packed: bcnn.BCNNPacked, stage_plan: StagePlan,
                 devices: Sequence, micro_batch: int, *,
                 path: str = "auto", conv_strategy: str | None = None,
                 conv_fusion: bool | None = None,
                 plan: "xplan.ExecutionPlan | None" = None):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        devices = resolve_devices(devices)
        if plan is None:
            plan = xplan.build_plan(packed, path=path,
                                    conv_strategy=conv_strategy,
                                    conv_fusion=conv_fusion,
                                    device=devices[0])
        self.plan = stage_plan          # the StagePlan (stage cut points)
        self.exec_plan = plan           # the ExecutionPlan (kernel choices)
        self.micro_batch = micro_batch
        self.conv_fusion = plan.conv_fusion
        self._n_classes = packed.fc3_w_words.shape[0]
        self.devices = tuple(devices[s % len(devices)]
                             for s in range(stage_plan.n_stages))
        self.device = self.devices[0]
        self._stages = tuple(
            _Stage(packed, stage_plan.bounds[s], stage_plan.bounds[s + 1],
                   plan, d) for s, d in enumerate(self.devices))
        self.streams = tuple(st.stream for st in self._stages
                             if st.stream is not None)
        cuda = bool(self.streams)
        # ready[s]: stage s's output is written; taken[s]: stage s has
        # copied its input out of stage s-1's output buffer
        self._ready = [torch.cuda.Event() if cuda else None
                       for _ in self._stages]
        self._taken = [torch.cuda.Event() if cuda else None
                       for _ in self._stages]
        self._closed = False

    @property
    def n_stages(self) -> int:
        return self.plan.n_stages

    @property
    def packed(self) -> bcnn.BCNNPacked:
        """The packed net being served (stage 0's owned copy; every stage
        holds the same)."""
        self._check_open()
        return self._stages[0].packed

    def fused_groups(self) -> tuple:
        """The per-stage fusion plans: one ``plan_layer_groups(a, b)``
        tuple per stage."""
        return tuple(
            bcnn.plan_layer_groups(self.plan.bounds[s],
                                   self.plan.bounds[s + 1],
                                   conv_fusion=self.conv_fusion)
            for s in range(self.n_stages))

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        self._check_open()
        n = x01.shape[0]
        if n == 0:          # empty batch → empty logits, nothing runs
            return torch.zeros((0, self._n_classes), dtype=torch.float32,
                               device=self.device)
        mb = self.micro_batch
        rows = -(-n // mb) * mb
        x = pad_rows(x01.to(self.device), rows)             # ragged tail
        out = torch.empty((rows, self._n_classes), dtype=torch.float32,
                          device=self.device)
        with ordered(self.device, self.streams):
            self._stream(x, out)
        return out[:n]

    def _stream(self, x: torch.Tensor, out: torch.Tensor) -> None:
        """Stream ``x`` (whole micro-batches) through the stages into
        ``out``, on the stages' streams, which the caller has ordered
        after the work that made ``x`` and ``out``.

        At tick t stage s holds micro-batch t−s; stages go back to front
        within a tick, so a stage reads its predecessor's output of the
        previous tick, and the ``taken`` event it records is the one its
        predecessor's next replay waits for (an event never recorded is
        not waited for)."""
        mb, n_st = self.micro_batch, self.n_stages
        n_micro = x.shape[0] // mb
        ys: list = [None] * n_st
        for t in range(n_micro + n_st - 1):
            for s in reversed(range(n_st)):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                st = self._stages[s]
                with on_stream(st.stream):
                    if s == 0:
                        src = x[m * mb:(m + 1) * mb]
                    else:
                        self._wait(st, self._ready[s - 1])
                        src = ys[s - 1]
                    if s + 1 < n_st:
                        self._wait(st, self._taken[s + 1])
                    ys[s] = st._run(src, loaded=self._taken[s])
                    if s + 1 < n_st:
                        if self._ready[s] is not None:
                            self._ready[s].record(st.stream)
                    else:
                        out[m * mb:(m + 1) * mb].copy_(ys[s])

    @staticmethod
    def _wait(stage: _Stage, event) -> None:
        if event is not None:
            stage.stream.wait_event(event)

    # ------------------------------------------------------------ contracts
    def swap(self, new_packed: bcnn.BCNNPacked) -> None:
        """Copy ``new_packed``'s weights into every stage's in place, each
        on its stage's stream after the caller's work (shapes and statics
        must match: ``core/bcnn.py::assert_swap_compatible``); no new
        capture."""
        bcnn.assert_swap_compatible(self.packed, new_packed)
        for st in self._stages:
            st.swap(new_packed)

    def cache_size(self) -> int:
        """The most CUDA graphs any one stage holds (on the CPU: input
        shapes any stage saw): 1 for every batch size, occupancy and
        ``swap``, 0 before the first call; ``close`` keeps it."""
        return max(st.cache_size() for st in self._stages)

    def stage_times(self, x01: torch.Tensor, reps: int = 3) -> list[float]:
        """Seconds one micro-batch takes in each stage, each stage alone
        (on the card device time between CUDA events over ``reps``
        replays, input copy included; on the CPU the host clock): a
        diagnostic for the eq. 12 balance, not the pipelined wall. The
        first call also captures."""
        self._check_open()
        mb = self.micro_batch
        h = pad_rows(x01[:mb].to(self.device), mb)
        times = []
        with ordered(self.device, self.streams):
            for st in self._stages:
                with on_stream(st.stream):
                    y = st._run(h)                  # warm (and capture)
                    if st.stream is None:
                        t0 = time.perf_counter()
                        for _ in range(reps):
                            st._run(h)
                        times.append((time.perf_counter() - t0) / reps)
                    else:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record(st.stream)
                        for _ in range(reps):
                            y = st._run(h)
                        end.record(st.stream)
                        end.synchronize()
                        times.append(start.elapsed_time(end) / 1e3 / reps)
                h = y
        return times

    def close(self) -> None:
        """Free every stage's graphs and weights and hand their streams
        back (``kernels/streams.py``); ``cache_size`` still answers."""
        self._closed = True
        for st in self._stages:
            st.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("this PipelinedForward was closed")


def make_pipelined_forward(packed: bcnn.BCNNPacked, *, n_stages: int,
                           micro_batch: int = 1, devices=None,
                           path: str = "auto",
                           conv_strategy: str | None = None,
                           conv_fusion: bool | None = None,
                           plan: "xplan.ExecutionPlan | None" = None
                           ) -> PipelinedForward:
    """An N-stage pipelined deployment forward: stages planned by
    ``plan_bcnn_stages`` (Table 2 cost balance), placed round robin onto
    ``devices`` (None: every CUDA device, raising when there is none;
    pass ``['cpu']`` for the plain PyTorch path). ``micro_batch`` is the
    streaming granule; the engine's default of 1 mirrors the paper's
    one-image-per-stage pipeline."""
    return PipelinedForward(packed, plan_bcnn_stages(n_stages), devices,
                            micro_batch, path=path,
                            conv_strategy=conv_strategy,
                            conv_fusion=conv_fusion, plan=plan)
