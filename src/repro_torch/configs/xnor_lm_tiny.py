"""XNOR LM (binarized transformer) serving configs (counterpart of
``repro/configs/xnor_lm_tiny.py``).

The repo's own binary LM workload, ``models/xnor_lm.py``, registered under
``BINARY_LM_MODULES`` so ``launch/serve.py --arch xnor-lm-tiny`` resolves
here. CONFIG is the served shape; SMOKE_CONFIG the CPU test shape.
"""
from repro_torch.models.xnor_lm import XnorLMConfig

CONFIG = XnorLMConfig(vocab_size=256, d_model=128, n_layers=4, n_heads=4,
                      d_ff=256, max_len=256)

SMOKE_CONFIG = XnorLMConfig(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                            d_ff=96, max_len=64)

SHAPES = [(1, 16), (4, 32)]
