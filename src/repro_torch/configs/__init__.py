"""Model configurations of the port, and the registry that resolves
``launch/serve.py --arch <id>`` (counterpart of ``repro/configs``). Only
the binary LM is registered: the published-architecture table comes with
the LM zoo."""
from __future__ import annotations

import importlib

BINARY_LM_MODULES = {
    "xnor-lm-tiny": "repro_torch.configs.xnor_lm_tiny",
}


def get_config(name: str, *, smoke: bool = False):
    """CONFIG (or SMOKE_CONFIG with ``smoke``) of the registered ``name``."""
    if name not in BINARY_LM_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(BINARY_LM_MODULES)}")
    m = importlib.import_module(BINARY_LM_MODULES[name])
    return m.SMOKE_CONFIG if smoke else m.CONFIG
