"""AdamW with global-norm clipping over a parameter tree (f32 master
weights): the reference's arithmetic as tensor ops.

``torch.optim.AdamW`` is not used: its rounding order differs from the
reference's (bias corrections folded into the step size, the decay applied
before the moment update). Here, as in the reference: the clip scale from
the global norm, the bias corrections with the step count in f32, and
``delta = m_hat / (sqrt(v_hat) + eps) + wd * p`` applied as ``p - lr *
delta``. The update is functional: new tensors, the inputs untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..arch.model import TensorSpec
from ..arch.params import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" is a memory-term lever


class AdamWState(NamedTuple):
    step: Any
    mu: Any
    nu: Any


def init_state(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """Zero moments of ``cfg.moment_dtype`` beside each parameter, and an
    int32 step count on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    device = tree_leaves(params)[0].device
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(z, params), nu=tree_map(z, params))


def state_specs(param_specs, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """``TensorSpec`` mirror of ``init_state``'s result (no allocation)."""
    dt = getattr(torch, cfg.moment_dtype)
    z = lambda p: TensorSpec(tuple(p.shape), dt)  # noqa: E731
    return AdamWState(step=TensorSpec((), torch.int32),
                      mu=tree_map(z, param_specs), nu=tree_map(z, param_specs))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """Returns (new_params, new_state, {"grad_norm": the unclipped global
    norm of ``grads``})."""
    f32 = torch.float32
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.to(f32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(f32))
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(f32)
        return ((p.to(f32) - cfg.lr * delta).to(p.dtype), m32.to(mdt),
                v32.to(mdt))

    def walk(p, g, m, v):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        return upd(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state.mu, state.nu)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
