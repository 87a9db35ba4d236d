"""yi-6b [dense] — arXiv:2403.04652 (llama-arch).

32L d_model=4096, 32 heads GQA kv=4, d_ff=11008, vocab 64000.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K, ModelConfig)

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "pure full (quadratic) attention"}
