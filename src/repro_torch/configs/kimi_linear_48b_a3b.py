"""kimi-linear-48b-a3b [moe] — arXiv:2510.26692
(hf: moonshotai/Kimi-Linear-48B-A3B-Instruct).

27L d_model=2304. Token mixers by layer: KDA (Kimi Delta Attention,
``models/kda.py``: 32 heads of 128, conv 4) at layers 1-3, 5-7, ...,
25-26, and MLA without RoPE (kv_lora=512, no q-lora, 32 heads, q/k
128 + 64 unrotated, v 128) at 4, 8, ..., 24, 27. Layer 1 keeps a dense
SwiGLU FFN of 9216; the other 26 a MoE of 256 routed experts of 1024,
top-8 by sigmoid score plus a selection bias, renormalised and scaled by
2.446, and 1 shared expert. Vocab 163840.

Only the port holds this architecture (``configs.PORT_ONLY_MODULES``).
``CONFIG`` holds all 256 experts; a deployment over expert-parallel
chips gives each layer its share with ``expert_share``.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                      PortModelConfig)

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26)

CONFIG = PortModelConfig(
    name="kimi-linear-48b-a3b", family="moe",
    n_layers=27, d_model=2304, n_heads=32, n_kv_heads=32,
    d_ff=9216, vocab_size=163840,
    attn_type="mla", kv_lora_rank=512, q_lora_rank=0,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=1024,
    first_dense_layers=1,
    kda_layers=KDA_LAYERS, kda_heads=32, kda_head_dim=128, mla_nope=True,
    router="sigmoid", routed_scale=2.446,
)

# the pattern's two mixers (KDA at 1-3, MLA at 4), the dense first layer,
# 16 experts (two shares of 8)
SMOKE_CONFIG = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_experts=16, top_k=4, moe_d_ff=32,
    head_dim=32, kda_layers=(1, 2, 3), kda_heads=2, kda_head_dim=16,
    remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "the MLA layers are full (quadratic) "
                               "attention"}
