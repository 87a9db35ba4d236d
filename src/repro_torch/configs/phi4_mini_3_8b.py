"""phi4-mini-3.8b [dense] — arXiv:2412.08905.

32L d_model=3072, 24 heads GQA kv=8, d_ff=8192, vocab 200064, RoPE+SwiGLU.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K, ModelConfig)

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "pure full (quadratic) attention"}
