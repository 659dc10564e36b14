"""Public entry point for the Mamba2 SSD scan, with its gradient:
``ssd_scan`` is a ``torch.autograd.Function`` whose backward runs the
backward kernel on a CUDA tensor and the plain backward on a CPU tensor."""
from __future__ import annotations

import torch

from ..common import KERNEL, resolve
from .kernel import ssd_scan_backward_cuda, ssd_scan_cuda
from .ref import ssd_backward_reference, ssd_chunked

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


def _check_shapes(x, dt, A, Bm, Cm, D, init_state, chunk: int) -> None:
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P) and Bm, Cm (B,S,G,N), got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G != 1:
        raise ValueError(f"ssd_scan takes one group (ngroups = 1, as every "
                         f"assigned arch), got {G}")
    want = {"dt": (B, S, H), "A": (H,), "Bm": (B, S, 1, N),
            "Cm": (B, S, 1, N), "D": (H,)}
    got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for x "
                             f"{tuple(x.shape)}, got "
                             f"{tuple(got[name].shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"init_state must be {(B, H, P, N)}, got "
                         f"{tuple(init_state.shape)}")
    if chunk < 1 or S % min(chunk, S):
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {min(chunk, S)}")


class _SSDScan(torch.autograd.Function):
    """The kernel (``kernel``) or the plain version. Where an input needs
    its gradient, the forward keeps the inputs; the backward is then the
    kernel's or the plain one, given the gradients of y and of the final
    state (either may be absent)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, chunk: int,
                kernel: bool):
        ctx.set_materialize_grads(False)
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(x, dt, A, Bm, Cm, D, init_state)
            ctx.chunk, ctx.kernel = chunk, kernel
        if kernel:
            return ssd_scan_cuda(x, dt, A, Bm, Cm, D, init_state)
        return ssd_chunked(x, dt, A, Bm, Cm, D, init_state, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        global _backward_invocations
        x, dt, A, Bm, Cm, D, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None \
            else dy.to(x.dtype).contiguous()
        if d_final is not None:
            d_final = d_final.to(torch.float32).contiguous()
        if ctx.kernel:
            grads = ssd_scan_backward_cuda(x, dt, A, Bm, Cm, D, dy, d_final)
            grads += (None,)
        else:
            grads = ssd_backward_reference(x, dt, A, Bm, Cm, D, dy,
                                           init_state, d_final,
                                           chunk=ctx.chunk)
        _backward_invocations += 1
        return (*grads, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             init_state=None, *, chunk: int = 64):
    """Chunked SSD scan. Returns ``(y (B,S,H,P) in x.dtype, final_state
    (B,H,P,N) f32)``; shapes as in ``ref.py``, one group. ``S`` must be a
    multiple of ``min(chunk, S)``, as in the reference. CPU tensors take
    the plain version (which continues from ``init_state``), CUDA tensors
    the kernel (which starts from zero; an ``init_state`` raises); any
    other device raises. Where autograd records the call, y and the final
    state carry the gradient of every input through the backward kernel
    (CUDA) or the plain backward (CPU)."""
    global _invocations
    _check_shapes(x, dt, A, Bm, Cm, D, init_state, chunk)
    chunk = min(chunk, x.shape[1])
    extra = () if init_state is None else (init_state,)
    out = _SSDScan.apply(x, dt, A, Bm, Cm, D, init_state, chunk,
                         resolve(x, dt, A, Bm, Cm, D, *extra) == KERNEL)
    _invocations += 1
    return out
