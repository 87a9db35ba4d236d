"""glm4-9b [dense] — hf: THUDM/glm-4-9b.

40L d_model=4096, 32 heads GQA kv=2, d_ff=13696, vocab 151552, RoPE.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K, ModelConfig)

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "pure full (quadratic) attention"}
