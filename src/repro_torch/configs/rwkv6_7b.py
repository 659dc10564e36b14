"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf].

Attention-free: time-mix with data-dependent per-channel decay + channel-mix.
head_size 64 -> 64 WKV heads. Decode uses O(1) recurrent state (no KV cache);
sub-quadratic -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892; hf",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    pattern=("rwkv6",),
    rwkv_head_size=64,
    subquadratic=True,
)
