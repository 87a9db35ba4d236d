"""deepseek-v2-236b [moe] — arXiv:2405.04434 (hf: deepseek-ai/DeepSeek-V2).

60L d_model=5120, 128 heads, MLA (kv_lora=512, q_lora=1536), MoE: 2 shared +
160 routed top-6, expert d_ff=1536, vocab 102400. First layer dense FFN
(width 12288).
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1,
    train_microbatches=16,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, kv_lora_rank=32, q_lora_rank=24, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_experts=8, top_k=2, moe_d_ff=32,
    head_dim=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "MLA is full (quadratic) attention"}
