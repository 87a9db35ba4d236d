"""qwen3-8b [dense] — hf: Qwen/Qwen3-8B.

36L d_model=4096, 32 heads GQA kv=8, head_dim=128, d_ff=12288,
vocab 151936, qk-norm.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K, ModelConfig)

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
    train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "pure full (quadratic) attention"}
