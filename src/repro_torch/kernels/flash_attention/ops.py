"""Public entry point for flash GQA attention (train / prefill), with its
gradient: ``flash_attention`` is a ``torch.autograd.Function`` whose forward
also keeps each row's log-sum-exp when an input needs its gradient, and
whose backward runs the backward kernels on a CUDA tensor and the plain
backward on a CPU tensor."""
from __future__ import annotations

import torch

from ..common import KERNEL, resolve
from .kernel import flash_attention_backward_cuda, flash_attention_cuda
from .ref import attention_backward_reference, attention_reference

#: Dispatch counters, one per call that ran. A CUDA tensor only ever reaches
#: the kernels, so on a card each forward count is one kernel launch and
#: each backward count one backward call (three launches: preprocess,
#: dK/dV, dQ).
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


class _FlashAttention(torch.autograd.Function):
    """The kernel (``kernel``) or the plain version. Where q, k or v needs
    its gradient, the forward also computes lse and keeps q, k, v, the
    output and lse; the backward is then the kernels' or the plain one."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kernel: bool):
        if not any(ctx.needs_input_grad[:3]):
            if kernel:
                return flash_attention_cuda(q, k, v, causal)
            return attention_reference(q, k, v, causal=causal)
        if kernel:
            out, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        else:
            out, lse = attention_reference(q, k, v, causal=causal,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kernel = causal, kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        global _backward_invocations
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.kernel:
            dq, dk, dv = flash_attention_backward_cuda(
                q, k, v, out, dout.contiguous(), lse, ctx.causal)
        else:
            dq, dk, dv = attention_backward_reference(q, k, v, out, lse, dout,
                                                      ctx.causal)
        _backward_invocations += 1
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D) in ``q.dtype``. The
    causal mask is aligned bottom-right (key u visible to query t when
    u <= t + Skv - Sq). CPU tensors take the plain version, CUDA tensors
    the kernel (or the call raises); any other device raises. Where
    autograd records the call (grad mode on, an input requiring grad), the
    result carries the gradient of q, k and v through the backward kernels
    (CUDA) or the plain backward (CPU)."""
    global _invocations
    _check_shapes(q, k, v, causal)
    out = _FlashAttention.apply(q, k, v, causal, resolve(q, k, v) == KERNEL)
    _invocations += 1
    return out
