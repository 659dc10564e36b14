"""Public entry point for the RWKV6 WKV scan."""
from __future__ import annotations

import torch

from ..common import KERNEL, forbid_autograd, resolve
from .kernel import wkv6_scan_cuda
from .ref import wkv6_chunked

#: Dispatch counter, one per call that ran. A CUDA tensor only ever reaches
#: the kernel, so on a card each count is one kernel launch.
_invocations = 0


def invocation_count() -> int:
    return _invocations


def reset_invocation_count() -> None:
    global _invocations
    _invocations = 0


def _check_shapes(r, k, v, w, u, init_state, chunk: int) -> None:
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r must be (B,S,H,K) and v (B,S,H,V), got "
                         f"{tuple(r.shape)}, {tuple(v.shape)}")
    B, S, H, K = r.shape
    V = v.shape[3]
    for name, t in (("k", k), ("w", w)):
        if tuple(t.shape) != (B, S, H, K):
            raise ValueError(f"{name} must be {(B, S, H, K)}, got "
                             f"{tuple(t.shape)}")
    if tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v {tuple(v.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be {(H, K)}, got {tuple(u.shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, K, V):
        raise ValueError(f"init_state must be {(B, H, K, V)}, got "
                         f"{tuple(init_state.shape)}")
    if chunk < 1 or S % min(chunk, S):
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {min(chunk, S)}")


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, init_state=None, *,
              chunk: int = 32):
    """Chunked WKV6 scan. Returns ``(y (B,S,H,V) in r.dtype, final_state
    (B,H,K,V) f32)``; shapes as in ``ref.py``. ``S`` must be a multiple of
    ``min(chunk, S)``, as in the reference. CPU tensors take the plain
    version (which continues from ``init_state``), CUDA tensors the kernel
    (which starts from zero; an ``init_state`` raises); any other device
    raises. On a card, a call that autograd would record raises: the
    kernel has no backward."""
    global _invocations
    _check_shapes(r, k, v, w, u, init_state, chunk)
    chunk = min(chunk, r.shape[1])
    extra = () if init_state is None else (init_state,)
    if resolve(r, k, v, w, u, *extra) == KERNEL:
        forbid_autograd("wkv6_scan", "ROADMAP.md Queue 1 item 4b",
                        r, k, v, w, u, *extra)
        out = wkv6_scan_cuda(r, k, v, w, u, init_state)
    else:
        out = wkv6_chunked(r, k, v, w, u, init_state, chunk=chunk)
    _invocations += 1
    return out
