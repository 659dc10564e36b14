"""Public entry point for the RWKV6 WKV scan, with its gradient:
``wkv6_scan`` is a ``torch.autograd.Function`` whose backward runs the
backward kernel on a CUDA tensor and the plain backward on a CPU tensor."""
from __future__ import annotations

import torch

from ..common import KERNEL, resolve
from .kernel import wkv6_scan_backward_cuda, wkv6_scan_cuda
from .ref import wkv6_backward_reference, wkv6_chunked

#: Dispatch counters, one per call that ran. A CUDA tensor only ever reaches
#: the kernels, so on a card each forward count is one kernel launch and
#: each backward count one backward call (the backward kernel, then the
#: launch that sums its partials).
_invocations = 0
_backward_invocations = 0


def invocation_count() -> int:
    return _invocations


def backward_invocation_count() -> int:
    return _backward_invocations


def reset_invocation_count() -> None:
    """Both counts, forward and backward, to 0."""
    global _invocations, _backward_invocations
    _invocations = 0
    _backward_invocations = 0


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


class _WKV6Scan(torch.autograd.Function):
    """The kernel (``kernel``) or the plain version. Where an input needs
    its gradient, the forward keeps the inputs; the backward is then the
    kernel's or the plain one, given the gradients of y and of the final
    state (either may be absent)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state, chunk: int, kernel: bool):
        ctx.set_materialize_grads(False)
        if any(ctx.needs_input_grad[:6]):
            ctx.save_for_backward(r, k, v, w, u, init_state)
            ctx.chunk, ctx.kernel = chunk, kernel
        if kernel:
            return wkv6_scan_cuda(r, k, v, w, u, init_state)
        return wkv6_chunked(r, k, v, w, u, init_state, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        global _backward_invocations
        r, k, v, w, u, init_state = ctx.saved_tensors
        dy = torch.zeros_like(v, dtype=r.dtype) if dy is None \
            else dy.to(r.dtype).contiguous()
        if d_final is not None:
            d_final = d_final.to(torch.float32).contiguous()
        if ctx.kernel:
            grads = wkv6_scan_backward_cuda(r, k, v, w, u, dy, d_final)
            grads += (None,)
        else:
            grads = wkv6_backward_reference(r, k, v, w, u, dy, init_state,
                                            d_final, chunk=ctx.chunk)
        _backward_invocations += 1
        return (*grads, None, None)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, init_state=None, *,
              chunk: int = 32):
    """Chunked WKV6 scan. Returns ``(y (B,S,H,V) in r.dtype, final_state
    (B,H,K,V) f32)``; shapes as in ``ref.py``. ``S`` must be a multiple of
    ``min(chunk, S)``, as in the reference. CPU tensors take the plain
    version (which continues from ``init_state``), CUDA tensors the kernel
    (which starts from zero; an ``init_state`` raises); any other device
    raises. Where autograd records the call, y and the final state carry
    the gradient of every input through the backward kernel (CUDA) or the
    plain backward (CPU)."""
    global _invocations
    _check_shapes(r, k, v, w, u, init_state, chunk)
    chunk = min(chunk, r.shape[1])
    extra = () if init_state is None else (init_state,)
    out = _WKV6Scan.apply(r, k, v, w, u, init_state, chunk,
                          resolve(r, k, v, w, u, *extra) == KERNEL)
    _invocations += 1
    return out
