"""InternLM2-20B [arXiv:2403.17297; hf]. GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    source="arXiv:2403.17297; hf",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    pattern=("attn",),
    rope_theta=1.0e6,
)
