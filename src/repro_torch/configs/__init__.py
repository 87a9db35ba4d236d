"""Model configurations of the port, and the registry that resolves
``launch/serve.py --arch <id>`` (counterpart of ``repro/configs``).

``ARCH_MODULES`` holds every published architecture of the reference (the
dense, moe, vlm, ssm, hybrid and audio families of
``models/transformer.py``); ``BINARY_LM_MODULES`` the XNOR LM
(``models/xnor_lm.py``); ``PORT_ONLY_MODULES`` the architectures only the
port runs (Kimi Linear), outside ``ARCH_NAMES``. Each module exports
``CONFIG``, ``SMOKE_CONFIG`` and ``SHAPES`` / ``SKIPPED_SHAPES`` (the
assigned input-shape cells).
"""
from __future__ import annotations

import importlib

ARCH_MODULES = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "yi-6b": "repro_torch.configs.yi_6b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(ARCH_MODULES)

BINARY_LM_MODULES = {
    "xnor-lm-tiny": "repro_torch.configs.xnor_lm_tiny",
}

# architectures the port runs that the reference's table does not hold;
# ``get_config`` resolves them, ``ARCH_NAMES`` stays the reference's set
PORT_ONLY_MODULES = {
    "kimi-linear-48b-a3b": "repro_torch.configs.kimi_linear_48b_a3b",
}


def _mod(name: str):
    if name in ARCH_MODULES:
        return importlib.import_module(ARCH_MODULES[name])
    if name in BINARY_LM_MODULES:
        return importlib.import_module(BINARY_LM_MODULES[name])
    if name in PORT_ONLY_MODULES:
        return importlib.import_module(PORT_ONLY_MODULES[name])
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(ARCH_MODULES) + sorted(BINARY_LM_MODULES)}"
                   f" + {sorted(PORT_ONLY_MODULES)}")


def get_config(name: str, *, smoke: bool = False, quant: str = "none"):
    """CONFIG (or SMOKE_CONFIG with ``smoke``) of the registered ``name``;
    ``quant`` replaces a transformer config's quant mode (the XNOR LM is
    binary by construction and ignores it)."""
    m = _mod(name)
    cfg = m.SMOKE_CONFIG if smoke else m.CONFIG
    if quant != "none" and name not in BINARY_LM_MODULES:
        cfg = cfg.with_(quant=quant)
    return cfg


def get_shapes(name: str):
    return list(_mod(name).SHAPES)


def get_skipped_shapes(name: str) -> dict[str, str]:
    return dict(getattr(_mod(name), "SKIPPED_SHAPES", {}))
