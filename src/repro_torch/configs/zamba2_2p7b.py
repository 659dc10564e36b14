"""Zamba2-2.7B [arXiv:2411.15242; hf].

Mamba2 backbone (54 SSD blocks, state=64) with a weight-SHARED attention+MLP
block applied once per 6-layer period (the paper's shared transformer block).
Attention is MHA-style (kv=32 = heads) with head_dim 80 on d_model 2560.
Sub-quadratic end-to-end -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    pattern=("mamba2",) * 6,
    shared_attn_every_period=True,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    subquadratic=True,
)
