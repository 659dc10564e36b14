"""Operation and byte counts of the work the cells do, from shapes alone.

``fleet_mlp_bytes`` / ``fleet_mlp_flops`` are a frozen copy of the count
the program's smoke run uses for ``fleet_mlp`` (``chip_smoke.py``
``fleet_mlp_bound``): each input read once and the output written once;
a multiply-add is two operations and each bias add one. The fit counts
the products alone: per row and epoch the forward's 2 P, the weight
gradients' 2 P and the input gradients' 2 (P - P0), where P counts the
matrix weights and P0 the first layer's, whose input needs no gradient.
"""
from __future__ import annotations

from typing import Sequence


def matrix_weights(sizes: Sequence[int]) -> int:
    """P: the matrix weights of an MLP with layer sizes ``sizes``."""
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def fleet_mlp_bytes(n: int, rows: int, sizes: Sequence[int],
                    elem: int = 4) -> int:
    """Bytes one ``fleet_mlp`` launch must move: x, every weight and
    bias stack, and the output."""
    params = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    return elem * (n * rows * sizes[0] + n * params + n * rows * sizes[-1])


def fleet_mlp_flops(n: int, rows: int, sizes: Sequence[int]) -> int:
    return sum(2 * n * rows * a * b + n * rows * b
               for a, b in zip(sizes[:-1], sizes[1:]))


def forward_flops(n: int, rows: int, sizes: Sequence[int]) -> int:
    """The products of one forward pass over ``rows`` rows an instance."""
    return 2 * n * rows * matrix_weights(sizes)


def fit_flops(n: int, rows: int, sizes: Sequence[int], epochs: int) -> int:
    """The products of ``epochs`` full-batch steps (forward and
    backward) over ``rows`` rows an instance."""
    p, p0 = matrix_weights(sizes), sizes[0] * sizes[1]
    return epochs * n * rows * (2 * p + 2 * p + 2 * (p - p0))


def rollout_flops(n: int, horizon: int, sizes: Sequence[int]) -> int:
    """The products of a ``horizon``-step rollout, one row a step."""
    return horizon * forward_flops(n, 1, sizes)
