"""rwkv6-3b [ssm] — "Finch" (arXiv:2404.05892), hf: RWKV/rwkv-6-world-3b.

32L d_model=2560 (attention-free), channel-mix d_ff=8960, vocab 65536.
Data-dependent decay time-mix; head size 64 → 40 heads. Sub-quadratic,
so the long_500k cell runs (O(1)/token state decode).
"""
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    attn_type="none", head_dim=64,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
    vocab_size=256, head_dim=64, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SKIPPED_SHAPES = {}
