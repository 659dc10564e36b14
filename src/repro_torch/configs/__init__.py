"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

One module per assigned architecture; exact published configs. Reduced smoke
variants via :func:`repro_torch.configs.base.reduced`.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeSpec, reduced
from .shapes import SHAPES, shape_applicable

from . import (qwen2_vl_7b, starcoder2_7b, llama3_8b, qwen3_1p7b,
               internlm2_20b, dbrx_132b, llama4_maverick_400b, zamba2_2p7b,
               hubert_xlarge, rwkv6_7b)

_ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen2_vl_7b, starcoder2_7b, llama3_8b, qwen3_1p7b, internlm2_20b,
    dbrx_132b, llama4_maverick_400b, zamba2_2p7b, hubert_xlarge, rwkv6_7b)}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(_ARCHS[name[: -len("-smoke")]])
    return _ARCHS[name]


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "reduced", "shape_applicable",
           "get_config", "list_archs"]
