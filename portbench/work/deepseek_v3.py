"""Model work of the DeepSeek-V3 family in decode, counted from a
configuration's widths (its published keys).

The yardstick of ``mfu.decode`` and ``hbm_roofline.decode``: the model's
work, whatever computes it.  FLOPs are counted in the absorbed form of the
latent attention (``layers/mla.py``), 2 a multiply-add, for one token of a
session at a step that attends to ``n`` positions (the token's own
included), D = hidden_size, H heads, C = kv_lora_rank, r the rope width:

    attention  2 D H (nope + r) + 2 D (C + r)      q; the latent and k_pe
               + 2 H nope C                        q_nope W_UK
               + 2 H (C + r) n + 2 H C n           scores; p . c_kv
               + 2 H C v + 2 H v D                 W_UV; W_o
    dense FFN  3 x 2 D F                           (the leading layers)
    MoE FFN    2 D E + k x 3 x 2 D F_e + 3 x 2 D (s F_e)   router; routed; shared
    head       2 D V

The least bytes of a step are what it has to read once: the weights of the
experts it routes to, the shared experts, attention and dense weights, the
routers, the head, and the latent cache of every position attended to, all
in bf16 (2 bytes).  The experts a step touches are the run's own where its
device counter read them (``experts_touched.decode``: the correction bias
leans the routing a little, 59.4 of 64 a layer at B = 32), else the count for
tokens that choose k of E experts uniformly and independently, E (1 - (1 -
k/E)^B), 61.26 of 64 at B = 32.  A decode request is
``seq_len`` steps from position ``context``; step j attends to ``context +
j + 1`` positions.
"""
from __future__ import annotations

from typing import Optional

BYTES = 2  # bf16


def _dims(cfg: dict) -> dict:
    c = {k: cfg[k] for k in ("hidden_size", "num_attention_heads", "qk_nope_head_dim",
                             "qk_rope_head_dim", "v_head_dim", "kv_lora_rank",
                             "intermediate_size", "moe_intermediate_size", "n_routed_experts",
                             "num_experts_per_tok", "n_shared_experts", "vocab_size",
                             "num_hidden_layers", "first_k_dense_replace")}
    return {k: int(v) for k, v in c.items()}


def attention_weights(cfg: dict) -> int:
    d = _dims(cfg)
    h, nope, r, v, c = (d["num_attention_heads"], d["qk_nope_head_dim"], d["qk_rope_head_dim"],
                        d["v_head_dim"], d["kv_lora_rank"])
    return d["hidden_size"] * (h * (nope + r) + c + r) + c * h * (nope + v) + h * v * d["hidden_size"]


def expert_weights(cfg: dict) -> int:
    d = _dims(cfg)
    return 3 * d["hidden_size"] * d["moe_intermediate_size"]


def token_flops(cfg: dict, n: int) -> int:
    """FLOPs of one token of a session at a step attending to ``n`` positions."""
    d = _dims(cfg)
    dm, h, nope, r, v, c = (d["hidden_size"], d["num_attention_heads"], d["qk_nope_head_dim"],
                            d["qk_rope_head_dim"], d["v_head_dim"], d["kv_lora_rank"])
    attn = (2 * dm * h * (nope + r) + 2 * dm * (c + r) + 2 * h * nope * c
            + 2 * h * (c + r) * n + 2 * h * c * n + 2 * h * c * v + 2 * h * v * dm)
    dense = 3 * 2 * dm * d["intermediate_size"]
    moe = (2 * dm * d["n_routed_experts"]
           + d["num_experts_per_tok"] * 2 * expert_weights(cfg)
           + 2 * d["n_shared_experts"] * expert_weights(cfg))
    k = d["first_k_dense_replace"]
    layers = d["num_hidden_layers"]
    return layers * attn + k * dense + (layers - k) * moe + 2 * dm * d["vocab_size"]


def experts_touched(cfg: dict, rows: int) -> float:
    """Experts a layer's step routes to, for ``rows`` tokens each choosing k
    of E uniformly."""
    d = _dims(cfg)
    e, k = d["n_routed_experts"], d["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** rows)


def step_bytes(cfg: dict, rows: int, n: int, experts: Optional[float] = None) -> float:
    """Least bytes of one decode step of ``rows`` sessions attending to
    ``n`` positions each; ``experts``, the experts a MoE layer's step routes
    to, where the run counted them, else :func:`experts_touched`."""
    d = _dims(cfg)
    if experts is None:
        experts = experts_touched(cfg, rows)
    dm, layers, k = d["hidden_size"], d["num_hidden_layers"], d["first_k_dense_replace"]
    moe_layers = layers - k
    weights = (layers * attention_weights(cfg)
               + k * 3 * dm * d["intermediate_size"]
               + moe_layers * (experts * expert_weights(cfg)
                               + d["n_shared_experts"] * expert_weights(cfg)
                               + dm * d["n_routed_experts"])
               + dm * d["vocab_size"])
    cache = rows * n * layers * (d["kv_lora_rank"] + d["qk_rope_head_dim"])
    return float(BYTES * (weights + cache))


def request_flops(cfg: dict, rows: int, seq_len: int, context: int) -> float:
    return float(rows * sum(token_flops(cfg, context + j + 1) for j in range(seq_len)))


def request_bytes(cfg: dict, rows: int, seq_len: int, context: int,
                  experts: Optional[float] = None) -> float:
    return sum(step_bytes(cfg, rows, context + j + 1, experts) for j in range(seq_len))
