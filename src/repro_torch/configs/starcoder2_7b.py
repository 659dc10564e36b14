"""StarCoder2-7B [arXiv:2402.19173; hf]. GQA kv=4, RoPE, LayerNorm + gelu MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    source="arXiv:2402.19173; hf",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    pattern=("attn",),
    rope_theta=1.0e5,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)
