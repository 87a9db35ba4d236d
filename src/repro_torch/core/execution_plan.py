"""ExecutionPlan: every kernel choice of the deployment forward in one
static, hashable object (counterpart of ``repro/core/execution_plan.py``).

* ``path`` — "vpu" (K1/K3/K5: XNOR + popcount on the CUDA cores), "mxu"
  (K2/K4/K5: ±1 int8 on the tensor cores) or "xla" (the plain PyTorch
  version, CPU only). "auto" resolves to "mxu" on a CUDA device and to
  "xla" on the CPU, as the reference resolves it to "mxu" on the TPU; the
  measured choice is ``kernels/autotune.py::autotune_packed``.
* ``conv_strategy`` — per layer, "direct"/"im2col" on the binary convs
  (indices 1..5), None elsewhere (``core/bconv.py::resolve_strategy``).
* ``conv_fusion`` and ``group_tiles`` — fuse CONV-3/4 and CONV-5/6 into
  the K5 kernel, with each pair's (th, tw) output tile
  (``kernels/xnor_conv_fused.py::pick_tiles`` by default).
* ``lm_mode`` — the XNOR LM's decode GEMM, "bw" (K6) or "xnor".

Tuned plans persist in the deployment artifact (``core/bcnn_artifact.py``
``tuning`` section), keyed by (backend, device kind, model geometry); a
key that does not match the serving host falls back to ``default_plan``.
"""
from __future__ import annotations

import dataclasses
import json
import zlib

import torch

from repro_torch.core import bcnn, bconv

DEFAULT_LM_MODE = "bw"   # the XNOR LM's decode GEMM mode
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
    conv_fusion:   fuse the same-resolution conv pairs (K5)
    group_tiles:   per fused pair ``(first_layer_idx, th, tw)``
    lm_mode:       XNOR LM decode GEMM mode, read by
                   ``models/xnor_lm.py::XnorLMServeModel``: "bw" (K6, the
                   weight-only matmul) or "xnor" (K1/K2 by ``path``);
                   measured by ``kernels/autotune.py::autotune_lm_mode``
    tuned:         True when measured by ``kernels/autotune.py``
    """
    path: str = "xla"
    conv_strategy: tuple = (None,) * bcnn.N_LAYERS
    conv_fusion: bool = False
    group_tiles: tuple = ()
    lm_mode: str = DEFAULT_LM_MODE
    tuned: bool = False

    def __post_init__(self):
        if self.path not in PLAN_PATHS:
            raise ValueError(f"unknown kernel path {self.path!r}")
        if len(self.conv_strategy) != bcnn.N_LAYERS:
            raise ValueError(
                f"conv_strategy must have {bcnn.N_LAYERS} entries, got "
                f"{len(self.conv_strategy)}")
        if self.lm_mode not in ("bw", "xnor"):
            raise ValueError(f"unknown lm_mode {self.lm_mode!r}")

    def strategy_for(self, idx: int) -> str | None:
        """Resolved conv dataflow for layer ``idx`` (None off conv layers)."""
        return self.conv_strategy[idx]

    def tiles_for(self, idx: int) -> tuple[int, int] | None:
        """(th, tw) of the fused group starting at layer ``idx``, or None
        to let ``kernels/xnor_conv_fused.py::pick_tiles`` decide."""
        for i, th, tw in self.group_tiles:
            if i == idx:
                return th, tw
        return None


def plan_to_dict(plan: ExecutionPlan) -> dict:
    """JSON-able form with the reference's keys: the artifact ``tuning``
    section's plan, and what logs print."""
    return {
        "path": plan.path,
        "conv_strategy": list(plan.conv_strategy),
        "conv_fusion": plan.conv_fusion,
        "group_tiles": [list(t) for t in plan.group_tiles],
        "lm_mode": plan.lm_mode,
        "tuned": plan.tuned,
    }


def plan_from_dict(d: dict) -> ExecutionPlan:
    """Inverse of ``plan_to_dict`` (also reads the reference's plans)."""
    return ExecutionPlan(
        path=d["path"],
        conv_strategy=tuple(d["conv_strategy"]),
        conv_fusion=bool(d["conv_fusion"]),
        group_tiles=tuple(tuple(int(x) for x in t)
                          for t in d["group_tiles"]),
        lm_mode=d.get("lm_mode", DEFAULT_LM_MODE),
        tuned=bool(d.get("tuned", False)),
    )


# ---------------------------------------------------------------------------
# Cache key: a plan is valid only for the (backend, device kind, geometry)
# it was measured on; anything else falls back to default_plan.
# ---------------------------------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the tensor's dtype ("int32", "bool", ...)."""
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def geometry_fingerprint(packed) -> str:
    """Fingerprint of a packed model's architecture: array shapes and
    dtypes and the static ints (k, filter sizes, eps), not the weight
    values. Built in ``core/bcnn_artifact.py::walk`` order with numpy
    dtype names, so it equals the reference's fingerprint of the same
    net."""
    from repro_torch.core.bcnn_artifact import walk
    parts = []
    for _, leaf in walk(packed):
        if isinstance(leaf, torch.Tensor):
            parts.append(f"{tuple(leaf.shape)}:{_dtype_name(leaf)}")
        else:
            parts.append(repr(leaf))
    return f"{zlib.crc32('|'.join(parts).encode()):08x}"


def backend_of(device) -> str:
    """"cuda" or "cpu": the backend half of the cache key."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def plan_cache_key(packed, device="cuda") -> dict:
    """The artifact ``tuning`` key: a cached plan is reused only when
    backend, device kind and geometry all match the serving host."""
    device = resolve_device(device)
    backend = backend_of(device)
    kind = (torch.cuda.get_device_name(device) if backend == "cuda"
            else "cpu")
    return {"backend": backend, "device_kind": kind,
            "geometry": geometry_fingerprint(packed)}


def plan_key_fingerprint(key: dict) -> str:
    """Canonical short form of a cache key (logs, filenames)."""
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(blob.encode()):08x}"


# ---------------------------------------------------------------------------
# default_plan: the heuristics
# ---------------------------------------------------------------------------

def _conv_resolution(idx: int, input_hw: tuple[int, int]) -> tuple[int, int]:
    """Input spatial extent of conv layer ``idx``: the image halves after
    every pooling layer before it (Table 2)."""
    h, w = input_hw
    for i in range(idx):
        if bcnn.CONV_SPECS[i][2]:
            h, w = h // 2, w // 2
    return h, w


def pair_geometry(packed, i: int, input_hw: tuple[int, int] = (32, 32)
                  ) -> dict:
    """Output extent and ``halo_scratch`` geometry of the fused pair
    (i, i+1): {"ho", "wo", "pf", "geom"}."""
    fa, fb = packed.convs[i - 1], packed.convs[i]
    h, w = _conv_resolution(i, input_hw)
    pf = 2 if bcnn.CONV_SPECS[i + 1][2] else 1
    oa, la = fa.w_words_hw.shape
    geom = dict(pf=pf, fha=fa.fh, fwa=fa.fw, cwa=la // (fa.fh * fa.fw),
                fhb=fb.fh, fwb=fb.fw, oa=oa)
    return {"ho": h // pf, "wo": w // pf, "pf": pf, "geom": geom}


def default_group_tiles(packed, groups, *,
                        input_hw: tuple[int, int] = (32, 32)) -> tuple:
    """The ``pick_tiles`` choice for every fused pair in ``groups`` —
    what ``kernels/ops.py::xnor_conv2d_pair`` computes when no tile is
    given."""
    from repro_torch.kernels import xnor_conv_fused as kfused
    tiles = []
    for group in groups:
        if len(group) != 2:
            continue
        pg = pair_geometry(packed, group[0], input_hw)
        th, tw = kfused.pick_tiles(pg["ho"], pg["wo"], **pg["geom"])
        tiles.append((group[0], th, tw))
    return tuple(tiles)


def build_plan(packed, *, path: str = "auto",
               conv_strategy: str | None = None,
               conv_fusion: bool | None = None,
               device=None,
               input_hw: tuple[int, int] = (32, 32)) -> ExecutionPlan:
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
    groups = bcnn.plan_layer_groups(conv_fusion=fusion)
    return ExecutionPlan(path=rpath, conv_strategy=tuple(strategies),
                         conv_fusion=fusion,
                         group_tiles=default_group_tiles(
                             packed, groups, input_hw=input_hw))


def default_plan(packed, device=None, *,
                 input_hw: tuple[int, int] = (32, 32)) -> ExecutionPlan:
    """The heuristic choices as one plan: the fallback whenever no valid
    tuned plan exists."""
    return build_plan(packed, device=device, input_hw=input_hw)
