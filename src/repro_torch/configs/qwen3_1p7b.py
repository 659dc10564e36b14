"""Qwen3-1.7B [hf:Qwen/Qwen3-8B; hf]. qk-norm, GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B; hf",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=("attn",),
    rope_theta=1.0e6,
    qk_norm=True,
    tie_embeddings=True,
)
