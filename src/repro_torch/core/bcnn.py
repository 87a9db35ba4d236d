"""The paper's 9-layer CIFAR-10 BCNN (Table 2), counterpart of
``repro/core/bcnn.py``.

    CONV-1  3→128   3×3  out 128×32×32   (FpDotProduct, eq. 7: 6-bit × 2-bit)
    CONV-2  128→128 3×3  +MP             out 128×16×16
    CONV-3  128→256 3×3                  out 256×16×16
    CONV-4  256→256 3×3  +MP             out 256×8×8
    CONV-5  256→512 3×3                  out 512×8×8
    CONV-6  512→512 3×3  +MP             out 512×4×4
    FC-1    8192→1024
    FC-2    1024→1024
    FC-3    1024→10  (Norm only, no binarize — paper Fig. 3 step 3)

``forward_train`` is the differentiable training forward (STE, batch-stat
BN; ``loss_fn``, ``update_running_stats``), ``forward_eval`` the same
graph with the stored BN statistics — the oracle the packed path is held
to. Both are plain PyTorch ops (``conv2d``, ``matmul``), as the
reference's training graph is plain XLA: no Pallas kernel has a backward.
``forward_packed`` is the deployment forward: packed int32 weights and
fused eq. 8 comparators through ``kernels/ops.py`` — on the card the five
binary convs launch the direct conv kernel (K3/K4) and the three FCs the
XNOR matmul (K1/K2); with conv fusion on, CONV-3/4 and CONV-5/6 run as
two fused pairs (K5) instead. Weight tensors are plain PyTorch tensors in
NamedTuples; ``packed_to`` moves a whole net to a device.
``PackedForward`` serves it: on the card one CUDA graph per input shape,
and weights hot-swapped in place (``split_packed``,
``assert_swap_compatible``).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bconv, bitpack, blinear
from repro_torch.core.binarize import binarize_ste
from repro_torch.core.normbinarize import BNParams, norm_only
from repro_torch.kernels import launch_count, ops

CONV_SPECS = [  # (in_ch, out_ch, maxpool) — paper Table 2
    (3, 128, False),    # CONV-1 (fp)
    (128, 128, True),   # CONV-2
    (128, 256, False),  # CONV-3
    (256, 256, True),   # CONV-4
    (256, 512, False),  # CONV-5
    (512, 512, True),   # CONV-6
]
FC_SPECS = [(8192, 1024), (1024, 1024), (1024, 10)]  # FC-1..3
BN_EPS = 1e-4
BN_MOMENTUM = 0.9
N_LAYERS = 9  # CONV-1..6 (indices 0..5) + FC-1..3 (indices 6..8)
_BN_FIELDS = ("bn_mean", "bn_var", "bn_gamma", "bn_beta")


class BCNNParams(NamedTuple):
    conv1: bconv.FpConvParams
    convs: tuple          # BConvParams × 5 (CONV-2..6)
    fcs: tuple            # BLinearParams × 3


class BCNNPacked(NamedTuple):
    conv1: bconv.FpConvParams          # first layer stays fixed-point (eq. 7)
    convs: tuple                       # BConvPacked × 5
    fcs: tuple                         # BLinearPacked × 2 (FC-1, FC-2)
    fc3_w_words: torch.Tensor          # packed FC-3 weights
    fc3_bn: BNParams                   # FC-3 ends with Norm (no binarize)
    fc3_k: int


def init(generator: torch.Generator) -> BCNNParams:
    """Latent params with the reference ``init``'s distributions: CONV-1
    N(0, 0.1²), binary layers U(−1, 1), BN at identity. The values differ
    from the reference's, whose ``jax.random`` stream torch cannot
    reproduce; parity tests hand weights across with ``params_from_numpy``
    or an artifact instead."""
    ci, co, _ = CONV_SPECS[0]
    return BCNNParams(
        conv1=bconv.fpconv_init(generator, ci, co),
        convs=tuple(bconv.init(generator, ci, co)
                    for ci, co, _ in CONV_SPECS[1:]),
        fcs=tuple(blinear.init(generator, fi, fo) for fi, fo in FC_SPECS))


def numpy_params(seed: int) -> BCNNParams:
    """Latent params as numpy float32 arrays with random BN statistics,
    made from ``seed``: the shared input of parity runs (tests feed the
    same arrays to the reference). Running means and variances sit at the
    scale of each layer's pre-activation (variance ≈ fan-in on the ±1
    layers), and γ takes both signs, so flipped comparators occur."""
    rng = np.random.default_rng(seed)

    def bn(o: int, scale: float) -> dict:
        return dict(
            bn_mean=rng.normal(0.0, 0.3 * np.sqrt(scale), o),
            bn_var=rng.uniform(0.5, 2.0, o) * scale,
            bn_gamma=rng.uniform(0.5, 1.5, o) * rng.choice([-1.0, 1.0], o),
            bn_beta=rng.normal(0.0, 0.3, o))

    def f32(d: dict) -> dict:
        return {k: np.asarray(v, np.float32) for k, v in d.items()}

    ci, co, _ = CONV_SPECS[0]
    conv1 = bconv.FpConvParams(**f32(dict(
        w=rng.normal(0.0, 0.1, (co, 3, 3, ci)), **bn(co, 400.0))))
    convs = tuple(bconv.BConvParams(**f32(dict(
        w=rng.uniform(-1.0, 1.0, (o, 3, 3, i)), **bn(o, 9.0 * i))))
        for i, o, _ in CONV_SPECS[1:])
    fcs = tuple(blinear.BLinearParams(**f32(dict(
        w=rng.uniform(-1.0, 1.0, (o, i)), **bn(o, float(i)))))
        for i, o in FC_SPECS)
    return BCNNParams(conv1=conv1, convs=convs, fcs=fcs)


def params_from_numpy(params) -> BCNNParams:
    """Latent params whose leaves are numpy arrays (the reference's
    ``BCNNParams`` mapped to numpy, or ``numpy_params``) → this port's
    ``BCNNParams`` of CPU float32 tensors. Read by attribute: ``conv1``,
    ``convs``, ``fcs``, each with ``w`` and the four ``bn_*`` fields."""
    def leaves(p) -> dict:
        return {f: torch.tensor(np.asarray(getattr(p, f), np.float32))
                for f in ("w",) + _BN_FIELDS}
    return BCNNParams(
        conv1=bconv.FpConvParams(**leaves(params.conv1)),
        convs=tuple(bconv.BConvParams(**leaves(p)) for p in params.convs),
        fcs=tuple(blinear.BLinearParams(**leaves(p)) for p in params.fcs))


# ---------------------------------------------------------------------------
# Training forward (STE) with batch-stat BN, and the stored-stat oracle
# ---------------------------------------------------------------------------

def _bn_train(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              axes: tuple[int, ...]):
    """Batch-stat BN: normalize with the biased batch variance, report the
    unbiased one (n/(n−1)) for the running statistics, which the eq. 8
    fold reads as a population estimate. Returns (z, mean, var_u)."""
    mean = torch.mean(y, dim=axes)
    var = torch.mean(torch.square(y - mean), dim=axes)
    z = (y - mean) / torch.sqrt(var + BN_EPS) * gamma + beta
    n = 1
    for a in axes:
        n *= y.shape[a]
    var_u = var * (n / (n - 1)) if n > 1 else var
    return z, mean, var_u


def train_layer(params: BCNNParams, idx: int, a: torch.Tensor):
    """Layer ``idx`` of ``forward_train``: its BN output z (before the
    binarize) and its batch statistics (mean, unbiased var).

    ``a`` is the layer's input: the (N, 32, 32, 3) image in [0, 1] for
    CONV-1 (idx 0), the previous layer's ±1 map or vector otherwise
    (FC-1, idx 6, flattens the (N, 4, 4, 512) map in hwc order)."""
    if idx == 0:
        p = params.conv1
        y = bconv.fpconv_train(p, a)
    elif 1 <= idx <= 5:
        p = params.convs[idx - 1]
        y = bconv.binary_conv(p, a, maxpool=CONV_SPECS[idx][2])
    elif 6 <= idx < N_LAYERS:
        p = params.fcs[idx - 6]
        y = a.reshape(a.shape[0], -1) @ binarize_ste(p.w).T
    else:
        raise ValueError(f"layer index {idx} out of range 0..{N_LAYERS - 1}")
    axes = (0,) if idx >= 6 else (0, 1, 2)
    z, mean, var = _bn_train(y, p.bn_gamma, p.bn_beta, axes)
    return z, (mean, var)


def forward_train(params: BCNNParams, x01: torch.Tensor):
    """(N, 32, 32, 3) image in [0, 1] → (logits, batch_stats).

    ``batch_stats`` holds (mean, unbiased var) of every normalized layer
    in layer order, for ``update_running_stats``. Every layer but FC-3
    ends in the STE binarize; FC-3 is Norm only."""
    stats = []
    a = x01
    for idx in range(N_LAYERS):
        z, st = train_layer(params, idx, a)
        stats.append(st)
        a = binarize_ste(z) if idx < N_LAYERS - 1 else z
    return a, stats


def update_running_stats(params: BCNNParams, stats) -> BCNNParams:
    """Fold fresh batch statistics into the stored running BN stats."""
    def upd(p, st):
        m, v = st
        return p._replace(
            bn_mean=BN_MOMENTUM * p.bn_mean + (1 - BN_MOMENTUM) * m,
            bn_var=BN_MOMENTUM * p.bn_var + (1 - BN_MOMENTUM) * v)
    return BCNNParams(
        conv1=upd(params.conv1, stats[0]),
        convs=tuple(upd(p, stats[1 + i]) for i, p in enumerate(params.convs)),
        fcs=tuple(upd(p, stats[6 + j]) for j, p in enumerate(params.fcs)))


def forward_eval(params: BCNNParams, x01: torch.Tensor) -> torch.Tensor:
    """Inference logits of the float ±1 graph with the stored BN
    statistics: the oracle of ``forward_packed``. CONV-1 is the
    deployment ``fpconv_apply``, so both start from the same bits."""
    a = bconv.fpconv_apply(params.conv1, x01)
    for i, p in enumerate(params.convs):
        a = bconv.apply_train(p, a, maxpool=CONV_SPECS[i + 1][2])
    a = a.reshape(a.shape[0], -1)
    for j, p in enumerate(params.fcs):
        a = blinear.apply_train(p, a, binarize_out=(j < 2))
    return a


def loss_fn(params: BCNNParams, x01: torch.Tensor, labels: torch.Tensor):
    """Softmax cross-entropy of ``forward_train``'s logits, and the batch
    statistics. Returns (loss, stats)."""
    logits, stats = forward_train(params, x01)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None].long()))
    return loss, stats


def fold_model(params: BCNNParams) -> BCNNPacked:
    """Fold latent params into the packed deployment net (eq. 8)."""
    p3 = params.fcs[2]
    return BCNNPacked(
        conv1=params.conv1,
        convs=tuple(bconv.fold(p) for p in params.convs),
        fcs=tuple(blinear.fold(p) for p in params.fcs[:2]),
        fc3_w_words=bitpack.pack_pm1(p3.w),
        fc3_bn=BNParams(p3.bn_mean, p3.bn_var, p3.bn_gamma, p3.bn_beta,
                        BN_EPS),
        fc3_k=p3.w.shape[1])


def _tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = [_tree_map(fn, x) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def packed_to(packed: BCNNPacked, device) -> BCNNPacked:
    """The same packed net with every tensor on ``device``."""
    return _tree_map(lambda t: t.to(device), packed)


def apply_packed_layer(packed: BCNNPacked, idx: int, h: torch.Tensor, *,
                       path: str = "mxu",
                       conv_strategy: str | None = None,
                       plan=None) -> torch.Tensor:
    """Apply ONE layer of the packed forward (paper Fig. 3).

    * idx 0 (CONV-1):   (N, 32, 32, 3) float image in [0, 1]
                        → (N, 32, 32, 128) {0,1} int8 bit map
    * idx 1..5 (CONV-2..6): {0,1} int8 NHWC bit maps in / out
    * idx 6 (FC-1):     (N, 4, 4, 512) bit map in — flattened in hwc order
                        and packed to (N, 256) words — → (N, 32) words out
    * idx 7 (FC-2):     (N, 32) int32 packed words in / out
    * idx 8 (FC-3):     (N, 32) words → (N, 10) float32 logits (Norm only)

    ``plan`` (``core/execution_plan.py::ExecutionPlan``) supplies the
    kernel path and the layer's conv strategy; without one the bare
    ``path``/``conv_strategy`` are used.
    """
    if plan is not None:
        path = plan.path
        conv_strategy = plan.strategy_for(idx)
    if idx == 0:
        return bitpack.encode_pm1(bconv.fpconv_apply(packed.conv1, h))
    if 1 <= idx <= 5:
        return bconv.apply_packed(packed.convs[idx - 1], h,
                                  maxpool=CONV_SPECS[idx][2], path=path,
                                  strategy=conv_strategy)
    if idx in (6, 7):
        if idx == 6:
            h = bitpack.pack_bits(h.reshape(h.shape[0], -1))
        return bitpack.pack_bits(blinear.apply_packed(packed.fcs[idx - 6], h,
                                                      path=path))
    if idx == 8:
        y_l = ops.xnor_matmul(h, packed.fc3_w_words, k=packed.fc3_k,
                              path=path)
        return norm_only(y_l, packed.fc3_bn, packed.fc3_k)
    raise ValueError(f"layer index {idx} out of range 0..{N_LAYERS - 1}")


def plan_layer_groups(start: int = 0, stop: int = N_LAYERS, *,
                      conv_fusion: bool | None = None
                      ) -> tuple[tuple[int, ...], ...]:
    """Partition layers [start, stop) into execution groups.

    With ``conv_fusion`` off (None → ``bconv.DEFAULT_CONV_FUSION``) every
    group is a singleton. With it on, consecutive binary convs at the same
    resolution — the first member does not pool — pair into one fused
    call: CONV-3/4 (16×16) and CONV-5/6 (8×8) in Table 2. A pooling layer
    only ends a group (its pool runs in the kernel's epilogue), and no
    group crosses [start, stop), the stage-cut contract of the reference's
    pipelined forward. Returns index tuples partitioning
    ``range(start, stop)`` in order.
    """
    fusion = (bconv.DEFAULT_CONV_FUSION if conv_fusion is None
              else bool(conv_fusion))
    groups = []
    i = start
    while i < stop:
        if (fusion and 1 <= i < 5 and i + 1 < stop
                and not CONV_SPECS[i][2]):
            groups.append((i, i + 1))
            i += 2
        else:
            groups.append((i,))
            i += 1
    return tuple(groups)


def apply_packed_group(packed: BCNNPacked, group: tuple[int, ...],
                       h: torch.Tensor, *, path: str = "mxu",
                       conv_strategy: str | None = None,
                       plan=None) -> torch.Tensor:
    """Apply one ``plan_layer_groups`` group: a singleton through
    ``apply_packed_layer``, an (i, i+1) pair through the fused
    ``bconv.apply_packed_pair`` — bit-exact with the two layers in turn.
    With a ``plan`` the path, the strategy of a singleton and the pair's
    (th, tw) tile come from it."""
    if len(group) == 1:
        return apply_packed_layer(packed, group[0], h, path=path,
                                  conv_strategy=conv_strategy, plan=plan)
    i, j = group
    if j != i + 1 or not 1 <= i < j <= 5:
        raise ValueError(f"not a fusible binary-conv pair: {group}")
    tiles = None
    if plan is not None:
        path = plan.path
        tiles = plan.tiles_for(i)
    return bconv.apply_packed_pair(packed.convs[i - 1], packed.convs[j - 1],
                                   h, maxpool_b=CONV_SPECS[j][2], path=path,
                                   tiles=tiles)


def forward_packed(packed: BCNNPacked, x01: torch.Tensor,
                   path: str = "mxu",
                   conv_strategy: str | None = None,
                   conv_fusion: bool | None = None,
                   plan=None) -> torch.Tensor:
    """Deployment forward: (N, 32, 32, 3) image in [0, 1] → (N, 10) logits.

    All kernel choices come from ONE ``plan``; when None, ``path``/
    ``conv_strategy``/``conv_fusion`` are resolved into one by
    ``core/execution_plan.py::build_plan`` on ``x01``'s device.
    """
    if plan is None:
        from repro_torch.core import execution_plan
        plan = execution_plan.build_plan(
            packed, path=path, conv_strategy=conv_strategy,
            conv_fusion=conv_fusion, device=x01.device,
            input_hw=tuple(x01.shape[1:3]))
    h = x01
    for group in plan_layer_groups(conv_fusion=plan.conv_fusion):
        h = apply_packed_group(packed, group, h, plan=plan)
    return h


# ---------------------------------------------------------------------------
# Weight hot-swap: the weight tensors are the leaves, the ints are statics
# ---------------------------------------------------------------------------

def _flatten(obj) -> list:
    """Leaves of a packed net, depth first in field order: tensors and the
    statics (ints, floats, None) — the reference's ``tree_flatten`` order
    with None kept as a leaf."""
    if isinstance(obj, tuple):
        return [leaf for x in obj for leaf in _flatten(x)]
    return [obj]


def _structure(obj):
    """The tree's shape without its leaves (NamedTuple names and arity)."""
    if isinstance(obj, tuple):
        return (type(obj).__name__, tuple(_structure(x) for x in obj))
    return "*"


def _is_weight(x) -> bool:
    return isinstance(x, torch.Tensor)


def split_packed(packed: BCNNPacked):
    """Split a packed net into (weight tensors, rebuild closure).

    The tensors come in the reference's leaf order
    (``repro/core/bcnn.py::split_packed``); ``rebuild(tensors)`` threads
    a replacement tuple back through the static skeleton (k, filter
    sizes, BN eps). The hot-swap contract rests on it: two nets whose
    tensors agree in shape and dtype and whose statics are equal run the
    same kernels at the same shapes, so a swap is a copy into the
    tensors a captured step reads."""
    def rebuild(arrs) -> BCNNPacked:
        it = iter(arrs)
        return _tree_map(lambda _: next(it), packed)

    return tuple(x for x in _flatten(packed) if _is_weight(x)), rebuild


def assert_swap_compatible(old: BCNNPacked, new: BCNNPacked) -> tuple:
    """Check that ``new`` can hot-swap into a forward built from ``old``
    with no new capture: the same tree, the same statics (k/fh/fw/eps),
    tensors of the same shapes and dtypes. Returns ``new``'s tensors in
    ``split_packed`` order; raises ValueError naming the first mismatch
    by its leaf index (the reference's messages)."""
    to, tn = _structure(old), _structure(new)
    if to != tn:
        raise ValueError(f"packed tree structure differs: {to} != {tn}")
    lo, ln = _flatten(old), _flatten(new)
    for i, (a, b) in enumerate(zip(lo, ln)):
        if _is_weight(a) != _is_weight(b):
            raise ValueError(f"leaf {i}: array/static kind mismatch "
                             f"({type(a).__name__} vs {type(b).__name__})")
        if _is_weight(a):
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"leaf {i}: shape/dtype mismatch {tuple(a.shape)}/"
                    f"{a.dtype} vs {tuple(b.shape)}/{b.dtype} — a swap must "
                    f"come from the same architecture (fold_model of "
                    f"identically-shaped params)")
        elif a != b:
            raise ValueError(f"leaf {i}: static mismatch {a!r} != {b!r} "
                             f"(k/filter-size/eps must be identical)")
    return tuple(x for x in ln if _is_weight(x))


class _Captured:
    """One function captured as a CUDA graph at one input: the static
    input buffer ``x`` it reads, the output ``y`` it writes, and the
    launches one replay runs (``kernels/launch_count.py``).

    Built on ``stream``, which must be current: a clone of the input, one
    eager run (it sets each kernel's attributes and fills
    ``csrc/bits.cuh::launch_cluster``'s table outside any capture), then
    the capture in thread-local mode, so another thread may serve while
    this one captures. A failed capture or replay raises; nothing falls
    back to eager launches. ``PackedForward`` and the stages of
    ``parallel/bcnn_pipeline.py::PipelinedForward`` hold these."""

    def __init__(self, fn, x: torch.Tensor, stream):
        self.x = x.clone()
        fn(self.x)
        self.graph = torch.cuda.CUDAGraph()
        with launch_count.recording() as launches:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.y = fn(self.x)
        self.launches = launches

    def replay(self) -> torch.Tensor:
        """Run the graph on what ``x`` holds and count its launches;
        returns ``y``, which the next replay overwrites."""
        self.graph.replay()
        launch_count.add_all(self.launches)
        return self.y


class PackedForward:
    """The packed forward bound to one device and one plan: a plain
    ``(N, 32, 32, 3) float32 → (N, 10) float32`` callable with weight
    hot-swap. The plan fixes every kernel choice: path, per-layer
    strategy, fusion of the conv pairs and their tiles
    (``core/execution_plan.py``).

    * **Owned weights.** Every tensor of the net is copied onto
      ``device``, so a swap never writes into the caller's net and two
      forwards built from one net share nothing.
    * **One CUDA graph per input shape** (the reference's one compile per
      shape). On the card the first call at a shape copies the input into
      a static buffer, runs one eager forward on the forward's own
      ``stream`` (``kernels/streams.py``: a pooled stream that no other
      open forward holds; the eager run also sets each kernel's
      attributes outside any capture), then captures the forward into a
      ``torch.cuda.CUDAGraph`` in thread-local mode, so another thread
      may serve while this one captures. Every call, the first included,
      copies its input into the buffer, replays, and returns a clone of
      the static output. A failed capture or replay raises; nothing falls
      back to eager launches. The launch counters count each replay's launches
      (``kernels/launch_count.py``). On the CPU the forward stays eager.
    * ``cache_size()``: graphs captured (on the CPU, input shapes seen);
      no ``swap`` changes it.
    * ``swap(new)``: validate (``assert_swap_compatible``), then copy
      every new tensor into the owned one on ``stream``, after any replay
      in flight: the tensors keep their storage, so the graphs read the
      new weights.

    One caller at a time: calls and swaps of one forward must not
    overlap (the engine that owns it is single-driver). ``close()``
    frees the graphs, the weights and the stream when no call will come.
    """

    def __init__(self, packed: BCNNPacked, *, path: str = "auto",
                 conv_strategy: str | None = None,
                 conv_fusion: bool | None = None,
                 plan=None, device="cuda"):
        from repro_torch.core import execution_plan
        self.device = execution_plan.resolve_device(device)
        self._packed = _tree_map(lambda t: t.to(self.device, copy=True),
                                 packed)
        self._weights = split_packed(self._packed)[0]
        if plan is None:
            plan = execution_plan.build_plan(
                self._packed, path=path, conv_strategy=conv_strategy,
                conv_fusion=conv_fusion, device=self.device)
        self._plan = plan
        self.stream = None
        self._release = None
        if self.device.type == "cuda":
            from repro_torch.kernels import streams
            self.stream = streams.acquire(self.device)
            self._release = weakref.finalize(self, streams.release,
                                             self.stream)
        self._steps: dict[tuple, _Captured] = {}
        self._shapes: set[tuple] = set()
        self._closed = False

    @property
    def packed(self) -> BCNNPacked:
        """The packed net being served (owned, on ``device``)."""
        self._check_open()
        return self._packed

    @property
    def plan(self):
        """The ``core/execution_plan.py::ExecutionPlan`` of every call."""
        return self._plan

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        self._check_open()
        x01 = x01.to(self.device)
        if self.stream is None:
            return self._run(x01)
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if caller != self.stream:
                self.stream.wait_stream(caller)
            out = self._run(x01).clone()
        if caller != self.stream:
            caller.wait_stream(self.stream)
            out.record_stream(caller)
        return out

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The function a graph captures (eager on the CPU)."""
        return forward_packed(self._packed, x, plan=self._plan)

    def _run(self, x: torch.Tensor, loaded=None) -> torch.Tensor:
        """``_forward(x)`` on the current stream, which on the card must be
        ``stream``; the caller orders that stream after the work that made
        ``x`` and before the work that reads the result. On the card: copy
        ``x`` (any device) into the graph of its shape (captured at first
        use), record the CUDA event ``loaded`` once it is copied (``x`` may
        then be overwritten), replay, and return the graph's output
        buffer, valid until the next replay at that shape."""
        key = (tuple(x.shape), x.dtype)
        if self.stream is None:
            self._shapes.add(key)
            return self._forward(x)
        step = self._steps.get(key)
        if step is None:
            step = _Captured(self._forward, x.to(self.device), self.stream)
            self._steps[key] = step
            self._shapes.add(key)
        step.x.copy_(x)
        if loaded is not None:
            loaded.record(self.stream)
        return step.replay()

    def cache_size(self) -> int:
        """CUDA graphs captured, one per input shape (on the CPU: input
        shapes seen); unchanged by any number of ``swap``s or by
        ``close``."""
        return len(self._shapes)

    def close(self) -> None:
        """Free the graphs and the owned weights and hand the stream back
        (``kernels/streams.py``) once no call will come: a retired
        replica's forward. ``cache_size`` still answers; calls, swaps
        and ``packed`` raise afterwards."""
        self._closed = True
        self._steps.clear()
        self._packed = None
        self._weights = ()
        if self._release is not None:
            self._release()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("this PackedForward was closed")

    def swap(self, new_packed: BCNNPacked) -> None:
        """Copy ``new_packed``'s weights into the served ones in place
        (shapes and statics must match: ``assert_swap_compatible``)."""
        self._check_open()
        new = assert_swap_compatible(self._packed, new_packed)
        if self.stream is None:
            for dst, src in zip(self._weights, new):
                dst.copy_(src)
            return
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if caller != self.stream:
                self.stream.wait_stream(caller)
            for dst, src in zip(self._weights, new):
                dst.copy_(src)
        if caller != self.stream:
            caller.wait_stream(self.stream)


def make_packed_forward(packed: BCNNPacked, *, path: str = "auto",
                        conv_strategy: str | None = None,
                        conv_fusion: bool | None = None,
                        plan=None, device="cuda") -> PackedForward:
    """Bind ``forward_packed`` to ``device`` (default the GPU; raises when
    there is none — pass ``device="cpu"`` for the plain PyTorch path): a
    ``PackedForward``, one CUDA graph per input shape on the card, with
    ``swap(new_packed)`` for an in-place weight hot-swap."""
    return PackedForward(packed, path=path, conv_strategy=conv_strategy,
                         conv_fusion=conv_fusion, plan=plan, device=device)
