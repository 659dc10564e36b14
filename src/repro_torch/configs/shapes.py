"""Assigned input-shape set (identical for every LM arch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / recurrent state of ``seq_len``), NOT ``train_step``.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeSpec

SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": ShapeSpec("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   ShapeSpec("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.full_attention_only:
        return False, "long_500k needs sub-quadratic attention; arch is pure full-attention"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention"
    if shape.kind == "prefill" and not cfg.is_decoder:
        # encoder-only archs still run prefill_32k as a plain encoder forward
        return True, ""
    return True, ""
