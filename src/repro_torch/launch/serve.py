"""LM serving entry point: continuous batching over decode slots (counterpart
of ``repro/launch/serve.py``, for the architectures the port has).

Two model families share the one slot engine (``serve/engine.py``):

* the LM zoo (``--arch`` from ``configs.ARCH_MODULES``: the dense
  ``qwen3-8b``, ``yi-6b``, ``glm4-9b``, ``phi4-mini-3.8b``, the moe
  ``deepseek-v2-lite-16b``, ``deepseek-v2-236b``, the vlm
  ``phi-3-vision-4.2b`` (served text only), the ssm ``rwkv6-3b``, the
  hybrid ``zamba2-7b`` and the audio ``whisper-medium``, each of whose
  requests brings float32 (encoder_seq, d_model) frame embeddings drawn
  from the request stream's generator right after its prompt):
  ``models/transformer.py`` with random weights from ``--seed``
  (``init_params``), in the linear-layer mode ``--quant``, served by the
  engine's default ``TransformerServeModel``;
* the XNOR LM (``--arch xnor-lm-tiny``, the default here; the
  reference defaults to ``qwen3-8b``): ``models/xnor_lm.py``'s binarized
  transformer folded to its packed form. On the card its decode GEMM is
  K6 (``--mode bw``) or K1/K2 (``--mode xnor`` with ``--path vpu|mxu``).

``--swap`` hot-swaps a second seed's weights after the first batch of
requests, serves again, and asserts that every weight tensor kept its
storage (the counterpart of the reference's one-compile assertion).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --requests 16 --slots 4 --max-new 16 --swap    # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen3-8b --smoke --swap                 # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch deepseek-v2-lite-16b --smoke --swap
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch zamba2-7b --smoke --swap     # also rwkv6-3b, phi-3-vision-4.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch whisper-medium --smoke --swap
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch xnor-lm-tiny --smoke --swap
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.execution_plan import resolve_device
from repro_torch.models import transformer, xnor_lm
from repro_torch.serve.engine import ServingEngine


def _run_requests(eng, cfg, args, rng):
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, (args.prompt_len,)).tolist()
        fe = None
        if getattr(cfg, "family", None) == "audio":
            fe = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        eng.submit(prompt, max_new_tokens=args.max_new, frontend=fe)
    t0 = time.perf_counter()
    out = eng.run()
    return out, time.perf_counter() - t0


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _build(args, cfg, device):
    """(engine, max_len, new weights for ``--swap`` from seed + 1)."""
    if args.arch in configs.BINARY_LM_MODULES:
        max_len = min(args.max_len, cfg.max_len)
        packed = xnor_lm.fold(cfg, xnor_lm.init(
            cfg, torch.Generator().manual_seed(args.seed)))
        eng, model = xnor_lm.make_serving_engine(
            cfg, packed, n_slots=args.slots, max_len=max_len, mode=args.mode,
            path=args.path, device=device)

        def swap_to():
            return model.swap_arrays(xnor_lm.fold(cfg, xnor_lm.init(
                cfg, torch.Generator().manual_seed(args.seed + 1))))
        return eng, max_len, swap_to
    params = transformer.init_params(cfg, _generator(args.seed, device),
                                     device)
    eng = ServingEngine(cfg, params, n_slots=args.slots,
                        max_len=args.max_len, device=device)
    del params                       # the engine holds its own copy

    def swap_to():
        return eng.model.swap_arrays(transformer.init_params(
            cfg, _generator(args.seed + 1, device), device))
    return eng, args.max_len, swap_to


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xnor-lm-tiny",
                    choices=configs.ARCH_NAMES
                    + tuple(configs.BINARY_LM_MODULES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's SMOKE_CONFIG")
    ap.add_argument("--quant", default="none",
                    choices=["none", "binary", "binary_weights"],
                    help="linear-layer mode of an LM zoo arch "
                         "(models/layers.py::dense)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mode", default="bw", choices=xnor_lm.MODES,
                    help="XNOR LM decode GEMM: weight-only binary matmul "
                         "(bw, K6) or full XNOR popcount (xnor, K1/K2)")
    ap.add_argument("--path", default="mxu", choices=["vpu", "mxu", "xla"],
                    help="kernel path of --mode xnor on the card (xla is "
                         "the plain version, CPU only)")
    ap.add_argument("--swap", action="store_true",
                    help="hot-swap a second seed's weights after the first "
                         "requests and assert the weights kept storage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke, quant=args.quant)
    rng = np.random.default_rng(args.seed)
    eng, max_len, swap_to = _build(args, cfg, device)
    print(f"engine on {device}: {args.arch}{' (smoke)' if args.smoke else ''},"
          f" {args.slots} slots, max_len {max_len}")
    out, dt = _run_requests(eng, cfg, args, rng)
    if args.swap:
        ptrs = [t.data_ptr() for t in eng.params]
        eng.swap_params(swap_to())
        assert [t.data_ptr() for t in eng.params] == ptrs, \
            "weight hot-swap must keep every weight tensor's storage"
        out2, dt2 = _run_requests(eng, cfg, args, rng)
        assert len(out2) == args.requests
        out = {**out, **out2}        # rids are engine-wide monotonic
        dt += dt2
        print(f"hot-swap OK: all {len(ptrs)} weight tensors kept their "
              f"storage across the swap")
    n_req = args.requests * (2 if args.swap else 1)
    n_tok = sum(len(v) for v in out.values())
    print(f"served {len(out)}/{n_req} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:,.1f} tok/s, "
          f"{eng.steps_executed} engine steps)")
    assert len(out) == n_req, "engine dropped requests"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
