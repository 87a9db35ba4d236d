"""zamba2-7b [hybrid] — arXiv:2411.15242 (Mamba2 + weight-shared attn blocks).

d_model=3584, 78 Mamba-2 layers with ONE weight-shared GQA(32H, kv=32)+MLP
(d_ff=14336) block applied every 6 SSM layers (13 applications); ssm_state=64;
vocab 32000. The published "81L" counts the shared-block applications inside
the layer total; we parameterize as 78 SSM layers + attn_every=6, which
reproduces the same compute graph (noted in DESIGN.md §4).
Sub-quadratic in the SSM path → the long_500k cell runs (the shared
attention uses its KV cache; it is the memory-dominant term at 524k).
"""
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=78, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    attn_type="gqa", ssm_state=64, attn_every=6,
    train_microbatches=16,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=4, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
    vocab_size=256, head_dim=64, ssm_state=16, attn_every=2, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SKIPPED_SHAPES = {}
