"""FLOPs a Kimi Linear prefill needs on its expert share, from the
configuration's sizes (``drivers/kimi_prefill_stream.py::file_sizes``):

* 2 x the parameters each token uses: KDA's projections, conv and gates
  on the KDA layers, MLA's projections on the others, the dense FFN of
  the first layers, the router over all experts, the shared expert, and
  the routed experts at k x held / all a token (8 x 128 / 256 = 4 on
  the share), the share's expected part;
* causal MLA attention at 2*H*(d_qk + d_v) a kept pair on each MLA layer;
* the delta rule token by token on each KDA layer: 7 * d_k * d_v a head
  and token (the decay of S, d_k*d_v; k^T S, 2*d_k*d_v; the rank-1
  update, 2*d_k*d_v; the read-out S^T q, 2*d_k*d_v);
* the head at each row's last position.

Embedding lookups, norms, the L2 norms, gates' activations and softmax
are not counted. Padded expert slots, dropped pairs and the chunked
form's extra work are not either: this is what the model needs, not
what the program does."""
from h100bench.work import attention


def _kda_params(c: dict) -> int:
    d = c["hidden_size"]
    w = c["kda_num_heads"] * c["kda_head_dim"]
    r = c["kda_gate_rank"]
    return (d * 3 * w + 4 * 3 * w + 2 * (d * r + r * w)
            + d * c["kda_num_heads"] + w * d)


def _mla_params(c: dict) -> int:
    d, h, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    return (d * h * (dn + dr) + d * (r + dr) + r * h * dn + r * h * dv
            + h * dv * d)


def n_kda(c: dict) -> int:
    return len(c["kda_layers"])


def token_params(c: dict) -> float:
    """Parameters one token multiplies through the decoder stack, the
    routed experts at their expected share."""
    d = c["hidden_size"]
    expert = 3 * d * c["moe_intermediate_size"]
    e = c["num_experts"]
    routed = c["num_experts_per_token"] * c["expert_share"][1] / e
    moe = (routed + c["num_shared_experts"]) * expert + d * e
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    return (n_kda(c) * _kda_params(c)
            + (c["num_hidden_layers"] - n_kda(c)) * _mla_params(c)
            + n_dense * 3 * d * c["intermediate_size"] + n_moe * moe)


def rule_flops_per_token(c: dict) -> float:
    """The delta rule's state work a token over every KDA layer."""
    dk = c["kda_head_dim"]
    return 7.0 * c["kda_num_heads"] * dk * dk * n_kda(c)


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """FLOPs of one prefill of ``batch`` rows of ``seq`` tokens that ends in
    each row's last-position logits."""
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = attention.flops(batch, c["num_attention_heads"], seq, d_qk,
                           c["v_head_dim"])
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * batch
    return ((2.0 * token_params(c) + rule_flops_per_token(c)) * batch * seq
            + (c["num_hidden_layers"] - n_kda(c)) * attn + head)


def attention_bound_s(c: dict, batch: int, seq: int) -> float:
    """Least time of one prefill's attention calls (one an MLA layer)."""
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return (c["num_hidden_layers"] - n_kda(c)) * attention.bound_s(
        batch, c["num_attention_heads"], seq, d_qk, c["v_head_dim"])
