"""Public entry point for the fleet-batched per-instance-weights MLP."""
from __future__ import annotations

from typing import List

import torch

from ..common import KERNEL, forbid_autograd, resolve
from .kernel import fleet_mlp_cuda
from .ref import fleet_mlp_reference

#: Dispatch counter, one per call that ran. A CUDA tensor only ever reaches
#: the kernel, so on a card each count is one kernel launch; scoring tests
#: and ``chip_smoke.py`` read it via ``invocation_count()``.
_invocations = 0


def invocation_count() -> int:
    return _invocations


def reset_invocation_count() -> None:
    global _invocations
    _invocations = 0


def _check_layers(x: torch.Tensor, weights: List[torch.Tensor],
                  biases: List[torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (N, b, F), got {tuple(x.shape)}")
    if not weights or len(weights) != len(biases):
        raise ValueError(f"need one bias per weight, got {len(weights)} "
                         f"weights and {len(biases)} biases")
    n, f = x.shape[0], x.shape[2]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 3 or w.shape[:2] != (n, f):
            raise ValueError(f"weights[{i}] must be ({n}, {f}, H), "
                             f"got {tuple(w.shape)}")
        f = w.shape[2]
        if tuple(b.shape) != (n, f):
            raise ValueError(f"biases[{i}] must be ({n}, {f}), "
                             f"got {tuple(b.shape)}")


def fleet_mlp(x: torch.Tensor, weights: List[torch.Tensor],
              biases: List[torch.Tensor]) -> torch.Tensor:
    """x: (N,b,F); weights/biases: per-layer stacks with leading N.
    Returns (N,b,O) in ``x.dtype``. ReLU between layers; final layer
    linear. CPU tensors take the plain version, CUDA tensors the kernel
    (or the call raises); any other device raises. On a card, a call
    that autograd would record raises: the kernel has no backward."""
    global _invocations
    _check_layers(x, weights, biases)
    if resolve(x, *weights, *biases) == KERNEL:
        forbid_autograd("fleet_mlp", x, *weights, *biases)
        out = fleet_mlp_cuda(x, weights, biases)
    else:
        out = fleet_mlp_reference(x, weights, biases)
    _invocations += 1
    return out
