"""Public entry point for flash GQA attention (train / prefill)."""
from __future__ import annotations

import torch

from ..common import KERNEL, resolve
from .kernel import flash_attention_cuda
from .ref import attention_reference

#: Dispatch counter, one per call that ran. A CUDA tensor only ever reaches
#: the kernel, so on a card each count is one kernel launch.
_invocations = 0


def invocation_count() -> int:
    return _invocations


def reset_invocation_count() -> None:
    global _invocations
    _invocations = 0


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B,Sq,H,D) and k, v (B,Skv,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if causal and Sq > k.shape[1]:
        raise ValueError(f"causal attention with more queries ({Sq}) than "
                         f"keys ({k.shape[1]}) leaves rows with no key")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D) in ``q.dtype``. The
    causal mask is aligned bottom-right (key u visible to query t when
    u <= t + Skv - Sq). CPU tensors take the plain version, CUDA tensors
    the kernel (or the call raises); any other device raises."""
    global _invocations
    _check_shapes(q, k, v, causal)
    if resolve(q, k, v) == KERNEL:
        out = flash_attention_cuda(q, k, v, causal)
    else:
        out = attention_reference(q, k, v, causal=causal)
    _invocations += 1
    return out
