"""whisper-medium [audio] — arXiv:2212.04356 (enc-dec backbone only).

24L encoder + 24L decoder, d_model=1024, 16 heads, d_ff=4096, vocab 51865,
LayerNorm + GELU. The conv frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (B, 1500, d_model).
Positional encoding deviates from the original (RoPE instead of learned
absolute) — systems-equivalent, noted in DESIGN.md §4.
"""
from repro_torch.configs.base import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    n_encoder_layers=24, encoder_seq=1500,
    frontend="audio_stub", norm_type="layernorm", mlp_type="gelu",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16, encoder_seq=32, remat=False)

SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K]
SKIPPED_SHAPES = {
    "long_500k": "full attention; 524k-token decode is semantically "
                 "undefined for 30 s audio windows (1500 frames)"}
