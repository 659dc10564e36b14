"""HuBERT-XLarge [arXiv:2106.07447; unverified].

Encoder-only (same transformer as wav2vec2): bidirectional attention,
LayerNorm + gelu. vocab=504 is the masked-prediction codebook. The
convolutional waveform frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, S, d_model).
No decode step exists (decode_32k / long_500k skipped).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447; unverified",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=("attn",),
    causal=False,
    is_decoder=False,
    norm="layernorm",
    act="gelu",
    frontend="frames",
)
