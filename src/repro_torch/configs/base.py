"""Model / shape configuration dataclasses.

A ``ModelConfig`` fully describes one LM-family architecture. Layer stacks are
expressed as a repeated ``pattern`` of block kinds so heterogeneous models
(MoE interleave, Mamba2-with-shared-attention) lower through a single
scan-over-superblocks code path:

    num_periods = layers_total // len(pattern)   (pattern repeats)

Block kinds:
    "attn"        dense attention + dense MLP
    "attn_moe"    dense attention + MoE MLP
    "mamba2"      Mamba2 (SSD) block + (no separate MLP; mamba block only)
    "rwkv6"       RWKV6 time-mix + channel-mix
A period may additionally end with one application of a weight-SHARED
attention block (Zamba2 style): ``shared_attn_every_period=True``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    source: str                      # citation tag from the assignment table

    num_layers: int                  # total blocks counted per the source
    d_model: int
    num_heads: int                   # query heads (attention blocks); 0 if attn-free
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[str, ...] = ("attn",)
    shared_attn_every_period: bool = False   # Zamba2: one weight-shared attn block per period

    # attention details
    rope_theta: float = 1.0e4
    use_mrope: bool = False          # Qwen2-VL multimodal RoPE (3 position streams)
    qk_norm: bool = False            # Qwen3 per-head RMSNorm on q,k
    causal: bool = True              # False => encoder-only
    is_decoder: bool = True          # False => no decode/serve step exists

    # norms / activations
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu (non-gated, d_ff is hidden width)
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0        # always-on shared expert(s) (Llama-4)

    # SSM (Mamba2)
    ssm_state: int = 0               # N: state dim per head
    ssm_head_dim: int = 64           # P: channels per SSD head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv: int = 4                # depthwise conv width

    # RWKV6
    rwkv_head_size: int = 64

    # modality frontend stub
    frontend: str = "none"           # none | patches (vlm) | frames (audio)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # capability flags
    subquadratic: bool = False       # may run long_500k

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived ----
    @property
    def period_len(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period_len == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {self.period_len}")
        return self.num_layers // self.period_len

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def has_attention(self) -> bool:
        return ("attn" in self.pattern or "attn_moe" in self.pattern
                or self.shared_attn_every_period)

    @property
    def full_attention_only(self) -> bool:
        """True if every block is quadratic attention (no sub-quadratic path)."""
        return all(k in ("attn", "attn_moe") for k in self.pattern) and not self.subquadratic


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (shapes only, no realism)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2 * cfg.period_len,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(2, cfg.num_kv_heads) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128,
        vocab_size=128,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, num_experts_per_tok=min(2, cfg.num_experts_per_tok))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if "rwkv6" in cfg.pattern:
        kw.update(rwkv_head_size=16)
    return cfg.replace(**kw)
