"""The DeepSeek-V3 family's settings: multi-head latent attention (MLA) and
DeepSeek-MoE, a port-only family (the JAX package has no such model).

``ModelConfig`` and ``MoEConfig`` are held field for field to the
reference's, so they take no new field: :class:`DeepSeekV3Config` adds
the family's own beside them, under the names of the published
``config.json`` (``model_type: deepseek_v3``).  Its ``family`` is
``"deepseek_v3"``; ``moe`` stays None, since the softmax router with a
capacity factor that ``MoEConfig`` describes is not this model's.

The inherited fields keep their meaning: ``d_ff`` is the leading dense
layers' SwiGLU width (``intermediate_size``), ``head_dim`` the query's and
key's width a head (``qk_nope_head_dim + qk_rope_head_dim``),
``max_seq_len`` the published context.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config.core import ModelConfig


@dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    # multi-head latent attention
    q_lora_rank: Optional[int] = None     # None: the query is one projection of x
    kv_lora_rank: int = 512               # width of the latent c_kv
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64            # one RoPE key, shared by every head
    v_head_dim: int = 128
    # DeepSeek-MoE
    first_k_dense_replace: int = 1        # leading dense layers
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    rms_norm_eps: float = 1e-6

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise ValueError("a low-rank query (q_lora_rank) is not ported; "
                             "the served configurations project it from x")
        if (self.scoring_func, self.topk_method) != ("sigmoid", "noaux_tc"):
            raise ValueError(f"routing {self.scoring_func}/{self.topk_method} is not "
                             f"ported; sigmoid/noaux_tc is")
        if self.n_group != 1 or self.topk_group != 1:
            raise ValueError("group-limited routing (n_group > 1) is not ported")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token a layer in the latent cache: c_kv and the RoPE key."""
        return self.kv_lora_rank + self.qk_rope_head_dim
