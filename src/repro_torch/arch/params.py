"""Parameter-spec machinery.

Every model declares a nested dict of :class:`ParamSpec` leaves. From that
single declaration come:
  * ``param_count`` — the exact parameter count
  * ``shape_structs`` — the tree as ``meta`` tensors (shapes, no storage)
  * ``init_tree``   — materialised parameters, drawn from a ``torch.Generator``
  * ``params_from_numpy`` — the same tree from arrays made elsewhere (the
    JAX package's parameters, handed over as numpy), leaf for leaf
  * ``partition_tree`` — a ``PartitionSpec`` tree via logical-axis rules
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # see _init_leaf
    scale: Optional[float] = None            # stddev / fill override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class PartitionSpec(tuple):
    """How a tensor is laid out over a named mesh, one entry per tensor
    dim: ``None`` (replicated), a mesh axis name, or a tuple of names (the
    dim split over those axes, the first outermost). The twin of
    ``jax.sharding.PartitionSpec``; ``distributed.sharding.placements``
    turns it into DTensor placements."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(f, tree):
    """Apply ``f`` to every leaf of a nested dict (a spec or a tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def tree_leaves(tree) -> list:
    """Leaves in the order of the JAX package's pytree flattening: dict
    keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Prepend a leading stacked dim (one entry per period)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        tree)


def partition_tree(tree, rules: dict, mesh_axes: Tuple[str, ...]):
    """Logical axes -> PartitionSpec. ``rules[name]`` is a mesh axis (or tuple
    of mesh axes) or None. Unknown logical names replicate."""
    def one(s: ParamSpec):
        out = []
        used: set = set()
        for ax in s.axes:
            m = rules.get(ax) if ax is not None else None
            if m is None:
                out.append(None)
                continue
            ms = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            ms = tuple(a for a in ms if a in mesh_axes and a not in used)
            used.update(ms)
            out.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return PartitionSpec(*out)
    return tree_map(one, tree)


# the most elements of a leaf drawn at once in f32: a leaf is drawn slice
# by slice into its tensor of the target dtype, so a draw holds the
# parameters plus one f32 slice (256 MiB), never a leaf-sized f32 copy
DRAW_SLICE = 1 << 26


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype, device):
    s = spec.shape
    fan_in = s[-2] if len(s) >= 2 else max(s[-1], 1)
    if spec.init == "zeros":
        return torch.zeros(s, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(s, dtype=dtype, device=device)
    if spec.init == "const":
        return torch.full(s, spec.scale or 0.0, dtype=dtype, device=device)

    def normal(n, std):
        return torch.randn(n, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    def uniform(n, lo, hi):
        u = torch.rand(n, generator=gen, dtype=torch.float32, device=device)
        return u.mul_(hi - lo).add_(lo)

    if spec.init == "normal":
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        draw = lambda n: normal(n, std)  # noqa: E731
    elif spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
        draw = lambda n: normal(n, std)  # noqa: E731
    elif spec.init == "ssm_A":     # A_log: log Uniform[1, 16]
        draw = lambda n: torch.log(uniform(n, 1.0, 16.0))  # noqa: E731
    elif spec.init == "ssm_dt":    # softplus^-1 of Uniform[1e-3, 1e-1]
        draw = lambda n: torch.log(torch.expm1(uniform(n, 1e-3, 1e-1)))  # noqa: E731
    elif spec.init == "rwkv_decay":  # w0 so that exp(-exp(w0)) ~ 0.85..0.99
        draw = lambda n: uniform(n, -3.0, -0.5)  # noqa: E731
    elif spec.init == "uniform_small":
        draw = lambda n: uniform(n, -0.5, 0.5).mul_(spec.scale or 1.0)  # noqa: E731
    else:
        raise ValueError(f"unknown init {spec.init}")
    out = torch.empty(s, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_SLICE):
        n = min(DRAW_SLICE, flat.numel() - i)
        flat[i:i + n] = draw(n)
    return out


def init_tree(tree, generator: torch.Generator, dtype=torch.float32,
              device="cpu"):
    """Materialise a spec tree with the JAX package's init laws. The draws
    come from ``generator`` (on ``device``), leaf by leaf in sorted-key
    order and each leaf in flat slices of ``DRAW_SLICE`` elements, so the
    values differ from ``jax.random``'s by design."""
    device = torch.device(device)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(t[k]) for k in sorted(t)}
        return _init_leaf(t, generator, dtype, device)
    return draw(tree)


def shape_structs(tree, dtype):
    """The spec tree as tensors on the ``meta`` device: each leaf's shape
    in ``dtype``, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), tree)


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def cast_tree(params, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's parameter tree, its leaves as numpy arrays (or
    anything ``np.asarray`` takes), as the port's tree of tensors on
    ``device``: same keys, same shapes, the stacked leading period axis
    kept. Floating leaves keep their dtype unless ``dtype`` is given."""
    device = torch.device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(one, tree)
