"""Unified model configuration of the LM zoo (a copy of
``repro/configs/base.py``; importing the reference's would pull in JAX).

One dataclass covers dense/GQA, MLA+MoE (DeepSeek-V2), RWKV-6, Mamba-2 hybrids,
enc-dec (Whisper) and VLM backbones; the port runs the dense and moe
families so far (``models/transformer.py``). Each ``configs/<arch>.py`` exports:

    CONFIG        — the exact published configuration
    SMOKE_CONFIG  — a reduced same-family config for CPU tests
    SHAPES        — the assigned (name → InputShape) cells for this arch

The paper's technique is a config knob: ``quant`` selects how linear layers
execute (``models/layers.py::dense``):
    "none"            — bf16 baseline
    "binary"          — paper-faithful: binary weights *and* activations
    "binary_weights"  — beyond-paper: ±1 weights × real activations
                        (XNOR-Net-style α scales)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class InputShape:
    """One assigned (arch × shape) cell."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


# The four LM shape cells from the assignment.
TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0            # 0 → = n_heads (MHA)
    head_dim: int = 0              # 0 → d_model // n_heads

    # --- attention flavour ---
    attn_type: str = "gqa"         # gqa | mla | none (attn-free)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None   # sliding-window width for hybrid long-ctx

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0           # 0 → no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0             # routed experts (0 → dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert FFN width
    first_dense_layers: int = 1    # DeepSeek: layer 0 keeps a dense FFN

    # --- SSM / RWKV / hybrid ---
    ssm_state: int = 0             # Mamba2 state size per head
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_every: int = 0            # hybrid: shared attn block every N ssm blocks

    # --- enc-dec / multimodal ---
    n_encoder_layers: int = 0      # >0 → encoder-decoder (Whisper)
    encoder_seq: int = 0           # stub frontend sequence length
    frontend: Optional[str] = None # "vision_stub" | "audio_stub"
    frontend_seq: int = 0          # prepended frame/patch embeddings (VLM)

    # --- misc ---
    mlp_type: str = "swiglu"       # swiglu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    quant: str = "none"            # none | binary | binary_weights
    remat: bool = True             # activation checkpointing over layer scan
    dtype: str = "bfloat16"
    # grad-accum microbatches for the train_4k cell (HBM-fit knob; see
    # EXPERIMENTS.md §Dry-run — chosen so args+temps < 16 GB/chip)
    train_microbatches: int = 4

    # Settings of architectures only the port holds (``PortModelConfig``
    # makes them fields). Here they are plain class attributes, not fields,
    # so a config of the reference's table reads today's behaviour and
    # ``dataclasses.asdict`` gives the reference's keys.
    kda_layers = ()
    kda_heads = 0
    kda_head_dim = 128
    mla_nope = False
    router = "softmax"
    routed_scale = 1.0
    expert_share = ()

    def __post_init__(self):
        if self.n_kv_heads == 0 and self.attn_type == "gqa":
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (long_500k) is semantically runnable."""
        return self.attn_type == "none" or self.ssm_state > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for 6·N·D MODEL_FLOPS and checkpoint sizing).
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd

        def attn_params() -> int:
            if self.attn_type == "mla":
                r, rq = self.kv_lora_rank, self.q_lora_rank
                qd = self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                q = d * rq + rq * qd if rq else d * qd
                kv = d * (r + self.qk_rope_head_dim)
                up = r * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                return q + kv + up + o
            if self.attn_type == "none":
                return 0
            return d * n_q + 2 * d * n_kv + n_q * d

        def ffn_params(width: int) -> int:
            mult = 3 if self.mlp_type == "swiglu" else 2
            return mult * d * width

        def layer_params(layer_idx: int) -> int:
            if self.family == "ssm":
                # rwkv6 block: 5 d² time-mix + (2·d_ff·d + d²) channel-mix
                return 6 * d * d + 2 * d * f
            if self.family == "hybrid":
                # mamba2 block: in_proj d×(2·d_inner+2N+nh) + out_proj
                d_inner = 2 * d
                nh = d_inner // 64
                return (d * (2 * d_inner + 2 * self.ssm_state + nh)
                        + d_inner * d)
            p = attn_params()
            if self.is_moe and layer_idx >= self.first_dense_layers:
                n_routed = self.top_k if active_only else self.n_experts
                p += (n_routed + self.n_shared_experts) * ffn_params(self.moe_d_ff)
                p += d * self.n_experts            # router
            else:
                p += ffn_params(f)
            return p

        total = sum(layer_params(i) for i in range(self.n_layers))
        if self.attn_every:  # hybrid: one shared attention(+ffn) block
            total += d * n_q + 2 * d * n_kv + n_q * d + ffn_params(f)
        total += v * d * (1 if self.tie_embeddings else 2)   # embed + head
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (d * n_q + 2 * d * n_kv + n_q * d
                                              + ffn_params(f) + n_q * d)
        return total


@dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ``ModelConfig`` with the fields of architectures the reference does
    not hold; every default is today's behaviour.

    Kimi Linear (``configs/kimi_linear_48b_a3b.py``): a per-layer mixer
    pattern inside the moe family, KDA linear attention
    (``models/kda.py``) beside MLA without RoPE, a sigmoid router with a
    selection bias and a scale on the gates, and an expert share."""
    # Each default is ModelConfig's class attribute of the same name.
    # 1-based numbers of the layers whose mixer is KDA (the release's
    # linear_attn_config.kda_layers); the others take ``attn_type``
    kda_layers: tuple = ModelConfig.kda_layers
    kda_heads: int = ModelConfig.kda_heads
    # d_k = d_v of a KDA head, and the width of its gates' low-rank
    # projections
    kda_head_dim: int = ModelConfig.kda_head_dim
    # MLA's 64-wide q/k part left unrotated
    mla_nope: bool = ModelConfig.mla_nope
    # softmax | sigmoid (the selection bias b picks the experts and
    # weights none)
    router: str = ModelConfig.router
    # routed_scaling_factor on the routed gates
    routed_scale: float = ModelConfig.routed_scale
    # (first, count) of the routed experts this layer holds of n_experts;
    # () holds them all
    expert_share: tuple = ModelConfig.expert_share
