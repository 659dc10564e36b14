"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

128 experts top-1 + one always-on shared expert, MoE interleaved on every
second layer (dense/MoE alternation) — this is what reconciles the published
400B-total / 17B-active budget with 48L x d=5120 x d_ff=8192:

  MoE params  = 24 layers x 128 experts x 3 x 5120 x 8192 ~ 386B
  dense rest  ~  14B   ->  ~400B total;  active ~ 17B (top-1 + shared).

Early-fusion multimodality is out of scope for the LM backbone (text path
only, per the assignment the frontend would be a stub anyway).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("attn", "attn_moe"),     # MoE every 2nd layer
    rope_theta=5.0e5,
    num_experts=128,
    num_experts_per_tok=1,
    n_shared_experts=1,
)
