"""What the benchmark takes from the program under test (``repro_torch``,
the PyTorch and CUDA port): the system built from the seed's weights, as
the configuration file describes it. The JAX package is never imported."""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# the BCNN
# ---------------------------------------------------------------------------

def bcnn_check_config(cfg: dict) -> None:
    """The port's BCNN is Table 2's: refuse a configuration file that
    describes another network."""
    from repro_torch.core import bcnn
    convs = [tuple(x) for x in cfg["conv_layers"]]
    fcs = [tuple(x) for x in cfg["fc_layers"]]
    if convs != [tuple(x) for x in bcnn.CONV_SPECS] or \
            fcs != [tuple(x) for x in bcnn.FC_SPECS]:
        raise ValueError(f"{cfg['name']}: the layers differ from the "
                         f"program's Table 2 network")


def bcnn_packed(latent: dict):
    """The seed's latent weights folded and packed by the program
    (``core/bcnn.py::fold_model``)."""
    from repro_torch.core import bcnn, bconv, blinear

    def fields(p):
        return {k: p[k] for k in ("w", "bn_mean", "bn_var", "bn_gamma",
                                  "bn_beta")}
    params = bcnn.BCNNParams(
        conv1=bconv.FpConvParams(**fields(latent["conv1"])),
        convs=tuple(bconv.BConvParams(**fields(p)) for p in latent["convs"]),
        fcs=tuple(blinear.BLinearParams(**fields(p)) for p in latent["fcs"]))
    return bcnn.fold_model(params)


def bcnn_engine(packed, device: str, **kw):
    """``serve/bcnn_engine.py::BCNNEngine.from_packed`` with the default
    plan (``core/execution_plan.py::build_plan``, no autotune)."""
    from repro_torch.serve.bcnn_engine import BCNNEngine
    return BCNNEngine.from_packed(packed, device=device, **kw)


# ---------------------------------------------------------------------------
# DeepSeek-V2
# ---------------------------------------------------------------------------

# configuration file key -> the port's ModelConfig field
_LM_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
            "num_attention_heads": "n_heads",
            "num_key_value_heads": "n_kv_heads",
            "intermediate_size": "d_ff", "vocab_size": "vocab_size",
            "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
            "qk_nope_head_dim": "qk_nope_head_dim",
            "qk_rope_head_dim": "qk_rope_head_dim",
            "v_head_dim": "v_head_dim", "n_routed_experts": "n_experts",
            "n_shared_experts": "n_shared_experts",
            "num_experts_per_tok": "top_k",
            "moe_intermediate_size": "moe_d_ff",
            "first_k_dense_replace": "first_dense_layers",
            "rope_theta": "rope_theta"}


def lm_config(cfg: dict, smoke: bool = False):
    """The port's ``ModelConfig`` of ``cfg["program"]`` with every size
    taken from the configuration file (``smoke``: the port's small
    same-family preset, for the CPU tests), at the file's dtype."""
    from repro_torch import configs
    base = configs.get_config(cfg["program"], smoke=smoke)
    if smoke:
        return base.with_(dtype=cfg["torch_dtype"])
    kw = {field_: (cfg[key] or 0) if key == "q_lora_rank" else cfg[key]
          for key, field_ in _LM_KEYS.items()}
    return base.with_(**kw, dtype=cfg["torch_dtype"], quant="none",
                      remat=False)


def lm_file_sizes(mcfg) -> dict:
    """The sizes of a port ``ModelConfig`` under the configuration file's
    keys (what the work counts and the reference read)."""
    return {key: getattr(mcfg, field_) for key, field_ in _LM_KEYS.items()}


def lm_prefill(mcfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``models/transformer.py::prefill``: (B, S) tokens -> (B, 1, vocab)
    last-position logits."""
    from repro_torch.models import transformer
    with torch.no_grad():
        return transformer.prefill(mcfg, params, tokens)
