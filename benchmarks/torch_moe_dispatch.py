#!/usr/bin/env python3
"""The MoE dispatch's buffer write and combine on the card, two forms side
by side in one process, on DeepSeek-V2-Lite at full width and depth
(bf16, random weights from seed 0):

    python3 benchmarks/torch_moe_dispatch.py

A: the reference's form, a scatter-add of every (token, choice) pair into
the (B, E, cap, D) buffer (zeros for a pair past capacity, added at slot
cap - 1) and the combine through the expert-sorted order, gathered back
to token order. B: ``models/moe.py::moe_apply``, a plain write with a
dropped pair sent to a slot no expert reads, and the combine gathered in
token order. Prints whether the two give bitwise equal prefill logits,
the prefill (1, 4096) in CUDA-event ms in turns A B B A, each form's
profile (launches, wall, kernel ms, idle share, top kernels) and the
4-slot decode step in turns A B B A, beside the card's name and power
limit. Needs one CUDA device.
"""
import importlib.util
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def moe_apply_a(p, cfg, x):
    """Form A: ``moe_apply`` with the reference's scatter-add dispatch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    quant = cfg.quant
    probs, gate_vals, expert_idx = moe.route(p, cfg, x)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((b * s * k,), 1.0 / (b * s * k), device=x.device))
    aux = e * torch.sum(me * ce)
    cap = moe.capacity(s, e, k)
    order, se, st, ok, slot = moe.dispatch(expert_idx, cap)
    rows = torch.arange(b, device=x.device)[:, None].expand(-1, s * k)
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, se, slot),
                   torch.where(ok[..., None], x[rows, st], 0).to(x.dtype),
                   accumulate=True)
    w = p["experts"]
    hb = buf.transpose(0, 1).reshape(e, b * cap, d)
    g = F.silu(layers.dense({"w": w["wg"]}, hb, quant))
    ob = layers.dense({"w": w["wo"]}, g * layers.dense({"w": w["wi"]}, hb,
                                                       quant), quant)
    out_buf = ob.reshape(e, b, cap, d).transpose(0, 1)
    sg = torch.gather(gate_vals.reshape(b, s * k), 1, order)
    contrib = torch.where(ok[..., None],
                          out_buf[rows, se, slot].to(torch.float32)
                          * sg[..., None], 0)
    back = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=x.device).expand(b, -1))
    y = torch.gather(contrib, 1, back[..., None].expand(-1, -1, d))
    y = y.reshape(b, s, k, d).sum(dim=2).to(x.dtype)
    if "shared" in p:
        y = y + layers.mlp_apply(p["shared"], x, cfg.mlp_type,
                                 quant).to(y.dtype)
    return y.to(x.dtype), aux


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs one CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print("card:", cs.smi("name,power.limit"), flush=True)
    full = configs.get_config("deepseek-v2-lite-16b")
    params = tf.init_params(full, torch.Generator(device=dev).manual_seed(0),
                            dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, full.vocab_size, (1, 4096))).to(dev)
    forms = {"A": moe_apply_a, "B": moe.moe_apply}
    out = {}
    try:
        for name, fn in forms.items():
            moe.moe_apply = fn
            out[name] = tf.prefill(full, params, toks)
        print("logits bitwise equal A vs B:",
              bool(torch.equal(out["A"], out["B"])), "max |diff|",
              float((out["A"].float() - out["B"].float()).abs().max()))
        times = {"A": [], "B": []}
        for name in "ABBA":
            moe.moe_apply = forms[name]
            times[name].append(cs.time_ms(
                lambda: tf.prefill(full, params, toks), reps=5, warmup=1))
        print("prefill (1, 4096) CUDA-event ms, A (scatter-add) / B (trash "
              "slot):", times)
        for name in "AB":
            moe.moe_apply = forms[name]
            cs.profile_call(lambda: tf.prefill(full, params, toks), 2,
                            f"prefill {name}")
        state = tf.init_serve_state(full, 4, 32, dev)
        feed = torch.zeros((4, 1), dtype=torch.int64, device=dev)
        for name in "ABBA":
            moe.moe_apply = forms[name]
            print("decode step", name, cs.time_ms(
                lambda: tf.decode_step(full, params, state, feed), reps=5,
                warmup=1), "ms (CUDA events)")
    finally:
        moe.moe_apply = forms["B"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
