"""Public entry points for single-token GQA decode attention: the
normalised output (``decode_attention``) and, for a sequence shard, the
softmax statistics (``decode_attention_partial``)."""
from __future__ import annotations

import torch

from ..common import KERNEL, forbid_autograd, resolve
from .kernel import decode_attention_cuda, decode_attention_partial_cuda
from .ref import decode_attention_partial_reference, decode_attention_reference

#: Dispatch counter, one per call that ran. A CUDA tensor only ever reaches
#: the kernels, so on a card each count is one call of the split-KV pair:
#: two launches, the partial pass and the combine pass.
_invocations = 0
#: The stats route's counter, one per ``decode_attention_partial`` call
#: (on a card the same two launches, the combine keeping the statistics).
_partial_invocations = 0


def invocation_count() -> int:
    return _invocations


def partial_invocation_count() -> int:
    return _partial_invocations


def reset_invocation_count() -> None:
    """Both routes' counters to 0."""
    global _invocations, _partial_invocations
    _invocations = _partial_invocations = 0


def _check_shapes(q, k_cache, v_cache, lengths) -> None:
    if (q.dim() != 3 or k_cache.dim() != 4
            or tuple(k_cache.shape) != tuple(v_cache.shape)):
        raise ValueError(f"q must be (B,H,D) and caches (B,S,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    KV = k_cache.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D), caches: (B,S,KV,D), lengths: (B,) -> (B,H,D) in
    ``q.dtype``; cache slots at and past ``lengths[b]`` are masked. CPU
    tensors take the plain version, CUDA tensors the kernel (or the call
    raises); any other device raises. On a card, a call that autograd
    would record raises: the kernel has no backward."""
    global _invocations
    _check_shapes(q, k_cache, v_cache, lengths)
    if resolve(q, k_cache, v_cache, lengths) == KERNEL:
        forbid_autograd("decode_attention", q, k_cache, v_cache)
        out = decode_attention_cuda(q, k_cache, v_cache, lengths)
    else:
        out = decode_attention_reference(q, k_cache, v_cache, lengths)
    _invocations += 1
    return out


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             lengths: torch.Tensor) -> tuple:
    """q: (B,H,D), caches: (B,S,KV,D), lengths: (B,) -> ``(o, m, l)`` in
    f32: the unnormalised output (B,H,D), each query head's largest valid
    score and its softmax denominator (B,H), over the cache's first
    ``lengths[b]`` slots. ``o / l`` is ``decode_attention``'s output; a row
    with no valid slot gives m = -1e30, l = 0, o = 0. Routed by device as
    ``decode_attention``; on a card a call that autograd would record
    raises."""
    global _partial_invocations
    _check_shapes(q, k_cache, v_cache, lengths)
    if resolve(q, k_cache, v_cache, lengths) == KERNEL:
        forbid_autograd("decode_attention", q, k_cache, v_cache)
        out = decode_attention_partial_cuda(q, k_cache, v_cache, lengths)
    else:
        out = decode_attention_partial_reference(q, k_cache, v_cache,
                                                 lengths)
    _partial_invocations += 1
    return out
