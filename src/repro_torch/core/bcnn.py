"""The paper's 9-layer CIFAR-10 BCNN (Table 2), deployment half
(counterpart of ``repro/core/bcnn.py``).

    CONV-1  3→128   3×3  out 128×32×32   (FpDotProduct, eq. 7: 6-bit × 2-bit)
    CONV-2  128→128 3×3  +MP             out 128×16×16
    CONV-3  128→256 3×3                  out 256×16×16
    CONV-4  256→256 3×3  +MP             out 256×8×8
    CONV-5  256→512 3×3                  out 512×8×8
    CONV-6  512→512 3×3  +MP             out 512×4×4
    FC-1    8192→1024
    FC-2    1024→1024
    FC-3    1024→10  (Norm only, no binarize — paper Fig. 3 step 3)

``forward_packed`` is the deployment forward: packed int32 weights and
fused eq. 8 comparators through ``kernels/ops.py`` — on the card the five
binary convs launch the direct conv kernel (K3/K4) and the three FCs the
XNOR matmul (K1/K2); with conv fusion on, CONV-3/4 and CONV-5/6 run as
two fused pairs (K5) instead. Weight tensors are plain PyTorch tensors in
NamedTuples; ``packed_to`` moves a whole net to a device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bconv, bitpack, blinear
from repro_torch.core.normbinarize import BNParams, norm_only
from repro_torch.kernels import ops

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


def _default_bn(o: int) -> dict:
    return dict(bn_mean=torch.zeros(o), bn_var=torch.ones(o),
                bn_gamma=torch.ones(o), bn_beta=torch.zeros(o))


def init(generator: torch.Generator) -> BCNNParams:
    """Latent params with the reference ``init``'s distributions: CONV-1
    N(0, 0.1²), binary layers U(−1, 1), BN at identity. The values differ
    from the reference's, whose ``jax.random`` stream torch cannot
    reproduce; parity tests hand weights across with ``params_from_numpy``
    or an artifact instead."""
    o, i = CONV_SPECS[0][1], CONV_SPECS[0][0]
    conv1 = bconv.FpConvParams(
        w=torch.randn((o, 3, 3, i), generator=generator) * 0.1,
        **_default_bn(o))
    convs = tuple(bconv.BConvParams(
        w=torch.rand((co, 3, 3, ci), generator=generator) * 2 - 1,
        **_default_bn(co)) for ci, co, _ in CONV_SPECS[1:])
    fcs = tuple(blinear.BLinearParams(
        w=torch.rand((fo, fi), generator=generator) * 2 - 1,
        **_default_bn(fo)) for fi, fo in FC_SPECS)
    return BCNNParams(conv1=conv1, convs=convs, fcs=fcs)


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


class PackedForward:
    """The packed forward bound to one device and one plan: a plain
    ``(N, 32, 32, 3) float32 → (N, 10) float32`` callable. The plan fixes
    every kernel choice: path, per-layer strategy, fusion of the conv
    pairs and their tiles (``core/execution_plan.py``).

    Unlike the reference's self-jitting forward it has no compile cache
    and no weight hot-swap: PyTorch runs eagerly, and CUDA-graph capture
    and ``swap`` come with a later slice of the port.
    """

    def __init__(self, packed: BCNNPacked, *, path: str = "auto",
                 conv_strategy: str | None = None,
                 conv_fusion: bool | None = None,
                 plan=None, device="cuda"):
        from repro_torch.core import execution_plan
        self.device = execution_plan.resolve_device(device)
        self._packed = packed_to(packed, self.device)
        if plan is None:
            plan = execution_plan.build_plan(
                self._packed, path=path, conv_strategy=conv_strategy,
                conv_fusion=conv_fusion, device=self.device)
        self._plan = plan

    @property
    def packed(self) -> BCNNPacked:
        """The packed net being served (on ``device``)."""
        return self._packed

    @property
    def plan(self):
        """The ``core/execution_plan.py::ExecutionPlan`` of every call."""
        return self._plan

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        return forward_packed(self._packed, x01.to(self.device),
                              plan=self._plan)


def make_packed_forward(packed: BCNNPacked, *, path: str = "auto",
                        conv_strategy: str | None = None,
                        conv_fusion: bool | None = None,
                        plan=None, device="cuda") -> PackedForward:
    """Bind ``forward_packed`` to ``device`` (default the GPU; raises when
    there is none — pass ``device="cpu"`` for the plain PyTorch path)."""
    return PackedForward(packed, path=path, conv_strategy=conv_strategy,
                         conv_fusion=conv_fusion, plan=plan, device=device)
