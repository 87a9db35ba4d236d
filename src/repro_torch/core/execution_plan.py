"""ExecutionPlan: every kernel choice of the deployment forward in one
static, hashable object (counterpart of ``repro/core/execution_plan.py``).

* ``path`` — "vpu" (K1/K3: XNOR + popcount on the CUDA cores), "mxu"
  (K2/K4: ±1 int8 on the tensor cores) or "xla" (the plain PyTorch
  version, CPU only). "auto" resolves to "mxu" on a CUDA device and to
  "xla" on the CPU, as the reference resolves it to "mxu" on the TPU.
* ``conv_strategy`` — per layer, "direct"/"im2col" on the binary convs
  (indices 1..5), None elsewhere (``core/bconv.py::resolve_strategy``).
* ``conv_fusion`` — always False here: the fused conv-pair kernel is not
  ported yet. Tiles and the tuner's cache key come with the tuner.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bcnn, bconv

PLAN_PATHS = ("vpu", "mxu", "xla")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there
    is no quiet fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return device


def resolve_path(path: str, device=None) -> str:
    """Resolve "auto": "mxu" on a CUDA device, "xla" on the CPU."""
    if path != "auto":
        if path not in PLAN_PATHS:
            raise ValueError(f"unknown kernel path {path!r}; "
                             f"use one of {PLAN_PATHS} or 'auto'")
        return path
    device = torch.device(device if device is not None else "cpu")
    return "mxu" if device.type == "cuda" else "xla"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static kernel-choice bundle for one deployment of one packed model.

    path:          resolved kernel variant — "vpu" | "mxu" | "xla"
    conv_strategy: per-layer resolved dataflow, length ``bcnn.N_LAYERS``
    conv_fusion:   fuse same-resolution conv pairs (not ported: False)
    """
    path: str = "xla"
    conv_strategy: tuple = (None,) * bcnn.N_LAYERS
    conv_fusion: bool = False

    def __post_init__(self):
        if self.path not in PLAN_PATHS:
            raise ValueError(f"unknown kernel path {self.path!r}")
        if len(self.conv_strategy) != bcnn.N_LAYERS:
            raise ValueError(
                f"conv_strategy must have {bcnn.N_LAYERS} entries, got "
                f"{len(self.conv_strategy)}")

    def strategy_for(self, idx: int) -> str | None:
        """Resolved conv dataflow for layer ``idx`` (None off conv layers)."""
        return self.conv_strategy[idx]


def build_plan(packed, *, path: str = "auto",
               conv_strategy: str | None = None,
               conv_fusion: bool | None = None,
               device=None) -> ExecutionPlan:
    """Resolve per-knob choices into a concrete ``ExecutionPlan`` with the
    reference's rules; ``device`` decides what "auto" means."""
    rpath = resolve_path(path, device)
    strategies = [None] * bcnn.N_LAYERS
    for idx in range(1, 6):
        fp = packed.convs[idx - 1]
        c = fp.k // (fp.fh * fp.fw)             # true input channel count
        strategies[idx] = bconv.resolve_strategy(conv_strategy, c, fp)
    fusion = (bconv.DEFAULT_CONV_FUSION if conv_fusion is None
              else bool(conv_fusion))
    bcnn.plan_layer_groups(conv_fusion=fusion)  # raises while not ported
    return ExecutionPlan(path=rpath, conv_strategy=tuple(strategies),
                         conv_fusion=fusion)


def default_plan(packed, device=None) -> ExecutionPlan:
    """The heuristic choices as one plan."""
    return build_plan(packed, device=device)
