"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf: deepseek-ai/DeepSeek-V2-Lite).

27L d_model=2048, MLA (kv_lora=512, no q-lora), MoE: 2 shared + 64 routed
top-6, expert d_ff=1408, vocab 102400. Note: the assignment line reads
"MoE 64e top-6 … 2 shared+160 routed"; 160 routed is the 236B config — the
Lite model has 64 routed experts (hf config), which we use here.
First layer keeps a dense FFN (width 10944), per the release.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_type="mla", kv_lora_rank=512, q_lora_rank=0,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_experts=4, top_k=2, moe_d_ff=32,
    head_dim=32, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]   # full attention → no long_500k
SKIPPED_SHAPES = {"long_500k": "MLA is full (quadratic) attention"}
