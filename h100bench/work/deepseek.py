"""FLOPs a DeepSeek-V2 prefill needs, from the configuration file's
published sizes: 2 x the parameters each token uses (MLA's projections,
the dense FFN of the first layers, the router, the shared and the top-k
routed experts), the head at the last position of each row only, and
causal attention at 2*H*(d_qk + d_v) per kept pair. Embedding lookups,
norms, RoPE and softmax are not counted. Padded expert slots and dropped
tokens are not either: this is what the model needs, not what the
program does."""
from h100bench.work import attention


def _mla_params(c: dict) -> int:
    d, h, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    rq = c.get("q_lora_rank") or 0
    q = d * rq + rq * h * (dn + dr) if rq else d * h * (dn + dr)
    return q + d * (r + dr) + r * h * dn + r * h * dv + h * dv * d


def token_params(c: dict) -> int:
    """Parameters one token multiplies through the decoder stack."""
    d = c["hidden_size"]
    dense_ffn = 3 * d * c["intermediate_size"]
    expert = 3 * d * c["moe_intermediate_size"]
    moe = ((c["num_experts_per_tok"] + c["n_shared_experts"]) * expert
           + d * c["n_routed_experts"])
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    return (c["num_hidden_layers"] * _mla_params(c) + n_dense * dense_ffn
            + n_moe * moe)


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """FLOPs of one prefill of ``batch`` rows of ``seq`` tokens that ends in
    each row's last-position logits."""
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = attention.flops(batch, c["num_attention_heads"], seq, d_qk,
                           c["v_head_dim"])
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * batch
    return (2.0 * token_params(c) * batch * seq
            + c["num_hidden_layers"] * attn + head)


def attention_bound_s(c: dict, batch: int, seq: int) -> float:
    """Least time of one prefill's attention calls (one a layer)."""
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return c["num_hidden_layers"] * attention.bound_s(
        batch, c["num_attention_heads"], seq, d_qk, c["v_head_dim"])
