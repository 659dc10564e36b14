"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

M-RoPE (3 positional streams: temporal/height/width), dynamic-resolution
vision frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings that replace the token embeddings of a vision
prefix.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191; hf",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=("attn",),
    rope_theta=1.0e6,
    use_mrope=True,
    frontend="patches",
)
