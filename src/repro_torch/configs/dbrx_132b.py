"""DBRX-132B [hf:databricks/dbrx-base; unverified].

Fine-grained MoE: 16 experts, top-4, every layer. GQA kv=8.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base; unverified",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=("attn_moe",),
    rope_theta=5.0e5,
    num_experts=16,
    num_experts_per_tok=4,
)
