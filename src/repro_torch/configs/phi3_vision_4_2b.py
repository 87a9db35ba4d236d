"""phi-3-vision-4.2b [vlm] — hf: microsoft/Phi-3-vision-128k-instruct.

phi3-mini backbone: 32L d_model=3072, 32 heads (kv=32 = MHA), d_ff=8192,
vocab 32064. The CLIP frontend is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (B, 576, d_model) that a single
projection maps into the sequence.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    frontend="vision_stub", frontend_seq=576,
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16, frontend_seq=16, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {"long_500k": "pure full (quadratic) attention"}
