"""Error-feedback int8 gradient compression for the slow cross-pod axis.

Between pods the links are several times slower than within one, so the
cross-pod gradient contribution is the one worth compressing: symmetric
per-tensor int8 (round half to even, no stochastic rounding) with error
feedback, the quantisation residual carried to the next step (Seide et
al. / Karimireddy et al.), which keeps training convergent.

``compress_with_feedback`` fits ``make_train_step``'s ``grad_hook`` once
the caller threads the error state (``FeedbackHook`` does): the
gradients are quantised and dequantised in place of the raw ones, and the
residual comes back as the new state. The twin of
``repro.distributed.compression``; trees are the port's (dicts, tuples,
lists, NamedTuples of tensors).
"""
from __future__ import annotations

import torch

from .checkpoint import flatten, tree_map


def quantize_int8(x):
    """x (f32) -> (int8 codes, scale), symmetric per tensor: scale =
    (max |x| + 1e-12) / 127, codes = round(x / scale) clipped to ±127."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes, scale):
    return codes.to(torch.float32) * scale


def compress_with_feedback(grads, error_state):
    """Returns (the compressed gradients dequantised, in each gradient's
    dtype; the new error state). Per leaf, with e the carried error:
    new_error = (g + e) - dequant(quant(g + e))."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        codes, scale = quantize_int8(corrected)
        deq = dequantize_int8(codes, scale)
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, e) for g, e in zip(flatten(grads), flatten(error_state))]
    deq, err = iter(p[0] for p in pairs), iter(p[1] for p in pairs)
    return (tree_map(lambda _: next(deq), grads),
            tree_map(lambda _: next(err), grads))


def init_error_state(params):
    """f32 zeros beside each parameter, on its device (a DTensor's keep
    its placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


class FeedbackHook:
    """``compress_with_feedback`` as a ``grad_hook``: the error state,
    ``error`` (None before the first call), threaded from one call to the
    next. (An object, not a closure that names itself: such a cycle would
    keep a model-sized error state alive until the cyclic collector
    runs.)"""

    def __init__(self):
        self.error = None

    def __call__(self, grads):
        if self.error is None:
            self.error = init_error_state(grads)
        grads, self.error = compress_with_feedback(grads, self.error)
        return grads


def wire_bytes_saved(params) -> int:
    """f32 all-reduce vs int8 + one f32 scale a tensor: the bytes saved
    per cross-pod reduction of ``params``' gradients."""
    leaves = flatten(params)
    total = sum(x.numel() for x in leaves)
    return total * 4 - (total * 1 + 4 * len(leaves))
