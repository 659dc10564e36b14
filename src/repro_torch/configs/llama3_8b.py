"""Llama-3-8B [arXiv:2407.21783; unverified]. GQA kv=8, 128k vocab."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783; unverified",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=("attn",),
    rope_theta=5.0e5,
)
