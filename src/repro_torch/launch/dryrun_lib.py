"""Dry-run machinery: an abstract trace of every (arch × shape × mesh) cell
of the LM zoo, and its roofline terms for the H100 (counterpart of
``repro/launch/dryrun_lib.py``).

The reference lowers and compiles each cell on a 512-device XLA mesh and
reads the compiled artifact. Here every tree is built under
``FakeTensorMode`` (the counterpart of ``jax.eval_shape``): fake tensors
on the CPU device, which hold no memory, so every kernel wrapper takes
its plain version and nothing launches (fake CUDA tensors would reach
the ctypes launchers). The cell's real program (``make_train_step``,
``prefill`` or the serve step) runs on them under
``launch/op_analysis.py::OpCounter``, which counts per-device FLOPs,
bytes and live bytes; the specs of ``parallel/sharding.py`` give each
leaf's per-device shard (``local_bytes``) and the collective model.
Nothing here touches a device or the environment.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import asdict, dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis
from repro_torch.models import transformer
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

# One H100 SXM: NVIDIA's data-sheet figures (dense, at the 700 W power
# limit), not measurements. NVLink 4 joins up to 8 GPUs of one node; a
# larger group goes over one 400 Gb/s NIC per GPU.
HW = {
    "peak_flops": 989e12,   # bf16 FLOP/s, tensor cores
    "hbm_bw": 3.35e12,      # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,     # bytes/s per direction, a group of <= 8
    "nvlink_group": 8,
    "nic_bw": 50e9,         # bytes/s per direction, a larger group
}


def link_bw(group: int) -> float:
    """Link bytes/s per direction of a collective over ``group`` devices."""
    return HW["nvlink_bw"] if group <= HW["nvlink_group"] else HW["nic_bw"]


def _fake_mode():
    """The active ``FakeTensorMode``, or a new one (fake CPU tensors)."""
    active = torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE)
    if active is not None:
        return contextlib.nullcontext(active)
    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def input_specs(cfg, shape: InputShape) -> dict:
    """Fake stand-ins for every model input of this cell."""
    gb, s = shape.global_batch, shape.seq_len
    with _fake_mode():
        fe = None
        if cfg.family == "vlm":
            fe = torch.empty((gb, cfg.frontend_seq, cfg.d_model),
                             dtype=torch.bfloat16)
        if cfg.family == "audio":
            fe = torch.empty((gb, cfg.encoder_seq, cfg.d_model),
                             dtype=torch.bfloat16)
        if shape.kind == "train":
            toks = torch.zeros((gb, s), dtype=torch.int64)
            return {"batch": transformer.Batch(tokens=toks, targets=toks,
                                               frontend=fe)}
        if shape.kind == "prefill":
            return {"tokens": torch.zeros((gb, s), dtype=torch.int64),
                    "frontend": fe}
        # decode: one new token against a seq_len cache
        state = transformer.init_serve_state(cfg, gb, s)
        if cfg.family == "audio":
            ekv = torch.zeros((cfg.n_layers, gb, cfg.encoder_seq,
                               cfg.n_heads, cfg.head_dim),
                              dtype=torch.bfloat16)
            state = state._replace(enc_kv=(ekv, ekv.clone()))
        return {"state": state, "tokens": torch.zeros((gb, 1),
                                                      dtype=torch.int64),
                "frontend": fe}


def abstract_params(cfg, *, serving_packed: bool = False) -> dict:
    """The parameter tree of ``cfg`` as fake tensors (packed for serving:
    ``serve/packing.py::pack_params_for_serving``)."""
    with _fake_mode():
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        if serving_packed:
            from repro_torch.serve.packing import pack_params_for_serving
            params = pack_params_for_serving(params)
        return params


def abstract_train_state(cfg, adamw: opt_lib.AdamW) -> train_loop.TrainState:
    with _fake_mode():
        return train_loop.init_train_state(
            cfg, torch.Generator().manual_seed(0), adamw, device="cpu")


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    quant: str
    ok: bool
    error: str = ""
    compile_s: float = 0.0          # seconds to build and trace the cell
    # per-device numbers (op_analysis.py's traced counts)
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    coll_link_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    dot_flops: float = 0.0
    # XLA-only in the reference (no XLA here): stay 0
    unpack_credit: float = 0.0
    convert_credit: float = 0.0
    t_memory_kernel: float = 0.0
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    # roofline terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    notes: str = ""
    fits: bool = False              # resident + temp bytes <= HBM

    def terms(self):
        return {"compute": self.t_compute, "memory": self.t_memory,
                "collective": self.t_collective}


def model_flops_for(cfg, shape: InputShape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    tokens per step; prefill: forward only → 2·N·D."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def _cuts(cfg) -> tuple:
    """(the config cut to one layer of each stack kind, [(kind, layers
    left out, the cut with one more layer of that kind)])."""
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        nm = cfg.n_layers - nd
        base = cfg.with_(first_dense_layers=min(nd, 1),
                         n_layers=min(nd, 1) + min(nm, 1))
        return base, [
            ("dense", nd - 1, base.with_(first_dense_layers=2,
                                         n_layers=base.n_layers + 1)),
            ("moe", nm - 1, base.with_(n_layers=base.n_layers + 1))]
    if cfg.family == "hybrid":
        every = cfg.attn_every or cfg.n_layers
        base = cfg.with_(n_layers=every)
        return base, [("mamba chunk", cfg.n_layers // every - 1,
                       cfg.with_(n_layers=2 * every))]
    base = cfg.with_(n_layers=1)
    kinds = [("layer", cfg.n_layers - 1, cfg.with_(n_layers=2))]
    if cfg.family == "audio":
        base = base.with_(n_encoder_layers=1)
        kinds = [("decoder", cfg.n_layers - 1, base.with_(n_layers=2)),
                 ("encoder", cfg.n_encoder_layers - 1,
                  base.with_(n_encoder_layers=2))]
    return base, kinds


def _param_specs(params, mesh, shape: InputShape):
    if shape.kind == "decode":
        return sharding.serving_param_specs(params, mesh)
    return sharding.param_specs(params, mesh)


def _batch_shards(mesh, batch: int) -> int:
    return (math.prod(mesh.shape[a] for a in mesh_lib.dp_axes(mesh))
            if sharding.batch_spec(mesh, batch) else 1)


def _trace(cfg, shape: InputShape, mesh, microbatches: int
           ) -> op_analysis.Costs:
    """Per-device costs of the cell's program at ``cfg`` (a depth cut)."""
    act_share = 1.0 / (_batch_shards(mesh, shape.global_batch)
                       * mesh.shape["model"])
    with _fake_mode():
        inputs = input_specs(cfg, shape)
        if shape.kind == "train":
            adamw = opt_lib.AdamW(
                clip_latent_unit=cfg.quant in ("binary", "binary_weights"))
            state = abstract_train_state(cfg, adamw)
            pspecs = sharding.param_specs(state.params, mesh)
            leaves = op_analysis.leaf_table(state.params, pspecs, mesh,
                                            gathered=True)
            for moments in (state.opt.m, state.opt.v):
                leaves.update(op_analysis.leaf_table(moments, pspecs, mesh,
                                                     gathered=False))
            step = train_loop.make_train_step(cfg, adamw,
                                              microbatches=microbatches)

            def run():
                step(state, inputs["batch"])
        else:
            packed = shape.kind == "decode" and cfg.quant in (
                "binary", "binary_weights")
            params = abstract_params(cfg, serving_packed=packed)
            leaves = op_analysis.leaf_table(
                params, _param_specs(params, mesh, shape), mesh,
                gathered=True)
            if shape.kind == "prefill":
                def run():
                    with torch.no_grad():
                        transformer.prefill(cfg, params, inputs["tokens"],
                                            inputs["frontend"])
            else:
                st = inputs["state"]
                leaves.update(op_analysis.leaf_table(
                    st, sharding.state_specs(st, mesh, shape.global_batch),
                    mesh, gathered=False))
                serve = train_loop.make_serve_step(cfg)

                def run():
                    with torch.no_grad():
                        serve(params, st, inputs["tokens"],
                              inputs["frontend"])
        counter = op_analysis.OpCounter(leaves, act_share)
        with counter, counter.attention_as_k7():
            run()
    return counter.costs


def trace_costs(cfg, shape: InputShape, mesh, microbatches: int = 1
                ) -> tuple[op_analysis.Costs, dict]:
    """Per-device costs of the whole cell: the cut to one layer of each
    stack kind, plus, for each kind, the layers left out times one
    layer's cost (the cut with one more layer, minus the cut); the live
    set grows by what one more layer keeps alive. Returns (costs,
    {kind: layers multiplied})."""
    base, kinds = _cuts(cfg)
    costs = _trace(base, shape, mesh, microbatches)
    total = costs
    counted = {}
    for kind, left_out, plus in kinds:
        if left_out <= 0:
            continue
        layer = _trace(plus, shape, mesh, microbatches).minus(costs)
        layer.live_bytes = max(layer.live_bytes, 0.0)
        total = total.plus(layer, left_out)
        counted[kind] = left_out + 1
    return total, counted


def analyze(cfg, shape: InputShape, mesh, microbatches: int) -> dict:
    """Roofline terms, resident bytes and the ``fits`` verdict of a cell
    (per device). Resident: the arguments (params, or the train state;
    plus the caches of a decode cell; plus the inputs) and, for a train
    step, the gradients."""
    costs, counted = trace_costs(cfg, shape, mesh, microbatches)
    train = shape.kind == "train"
    tp = mesh.shape["model"]
    dp = mesh_lib.dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    inputs = input_specs(cfg, shape)
    data = inputs["batch"] if train else {"tokens": inputs["tokens"],
                                          "frontend": inputs["frontend"]}
    args = sharding.local_bytes(
        data, sharding.data_specs(mesh, shape.global_batch, data), mesh)
    if train:
        state = abstract_train_state(cfg, opt_lib.AdamW())
        params = state.params
        pspecs = sharding.param_specs(params, mesh)
        grads = sharding.local_bytes(params, pspecs, mesh)
        args += grads + 2 * sharding.local_bytes(state.opt.m, pspecs, mesh)
        args += state.opt.step.element_size()
        resident = args + grads
        gathers, reductions = (2 if cfg.remat else 1) * microbatches, \
            microbatches
    else:
        packed = shape.kind == "decode" and cfg.quant in ("binary",
                                                          "binary_weights")
        params = abstract_params(cfg, serving_packed=packed)
        pspecs = _param_specs(params, mesh, shape)
        args += sharding.local_bytes(params, pspecs, mesh)
        if shape.kind == "decode":
            st = inputs["state"]
            args += sharding.local_bytes(
                st, sharding.state_specs(st, mesh, shape.global_batch), mesh)
        resident = args
        gathers, reductions = 1, 0
    link, counts = op_analysis.fsdp_link_bytes(
        params, pspecs, mesh, dp, gathers=gathers, reductions=reductions)
    t_coll = link / link_bw(n_dp) if link else 0.0
    if tp > 1:
        mirror = 2 if train else 1      # a train step's backward mirrors
        ar = op_analysis.link_bytes_for(
            "all-reduce", mirror * costs.tp_fwd + costs.tp_remat, tp)
        a2a = op_analysis.link_bytes_for(
            "all-to-all", mirror * costs.ep_fwd + costs.ep_remat, tp)
        link += ar + a2a
        t_coll += (ar + a2a) / link_bw(tp)
        for op, n in (("all-reduce", mirror * costs.n_tp_fwd
                       + costs.n_tp_remat),
                      ("all-to-all", mirror * costs.n_ep_fwd
                       + costs.n_ep_remat)):
            if n:
                counts[op] = counts.get(op, 0) + n
    t_c = costs.flops / HW["peak_flops"]
    t_m = costs.bytes / HW["hbm_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_coll}
    mf = model_flops_for(cfg, shape)
    return {
        "hlo_flops": costs.flops, "hlo_bytes": costs.bytes,
        "coll_link_bytes": link,
        "coll_counts": {k: round(v, 1) for k, v in counts.items()},
        "dot_flops": costs.flops, "t_memory_kernel": t_m,
        "arg_bytes": float(args), "temp_bytes": costs.live_bytes,
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_coll,
        "bottleneck": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_ratio": (mf / (costs.flops * mesh.size)
                         if costs.flops else 0.0),
        "fits": resident + costs.live_bytes <= HW["hbm_bytes"],
        "notes": (f"layers traced once and multiplied: {counted}; "
                  f"resident {resident:.6g} B; {costs.ops:.0f} ops; "
                  f"hlo_* are the traced op counts; unpack_credit, "
                  f"convert_credit, xla_flops and xla_bytes are XLA-only "
                  f"and stay 0"),
    }


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def run_cell(arch: str, shape: InputShape, *, multi_pod: bool = False,
             quant: str = "none", microbatches: int = 0, pods: int = 0,
             mesh=None) -> CellResult:
    """One cell on the production mesh (or on ``mesh``, e.g.
    ``make_local_mesh``); a failure is data, in ``error``."""
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, pods=pods)
    cfg = configs.get_config(arch, quant=quant)
    if microbatches == 0:   # default: per-arch grad accumulation (HBM fit)
        microbatches = cfg.train_microbatches if shape.kind == "train" else 1
    res = CellResult(arch=arch, shape=shape.name, mesh=mesh_name(mesh),
                     quant=quant, ok=False)
    t0 = time.time()
    try:
        for k, v in analyze(cfg, shape, mesh, microbatches).items():
            setattr(res, k, v)
        res.ok = True
    except Exception as e:  # noqa: BLE001 — cell failures are data
        res.error = f"{type(e).__name__}: {e}"[:500]
    res.compile_s = time.time() - t0
    return res


def cells_for(arch: str) -> list[InputShape]:
    return configs.get_shapes(arch)


def save_result(res: CellResult, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{res.arch}__{res.shape}__{res.mesh}__{res.quant}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(asdict(res), f, indent=1)


def load_results(out_dir: str) -> list[dict]:
    out = []
    if not os.path.isdir(out_dir):
        return out
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                out.append(json.load(f))
    return out
