"""Mixture-of-Experts MLP with top-k routing.

Execution paths:
  * ``dispatch`` (default): capacity-bounded dispatch with GShard's dropping
    semantics. Tokens are split into groups; each (group, expert) has C
    slots, filled first come first served by (token, choice); a choice past
    C is dropped and its token keeps only its residual (and the shared
    expert). The experts compute on an (E, G, C, d) buffer. Where the
    reference builds one-hot dispatch and combine tensors and contracts
    them, the buffer here is filled by one gather and read back by another:
    every slot has at most one source, so the values are the same.
  * ``dense``: every expert computes every token (smoke configs only; the
    cross-check of the dispatch path).

Aux losses: Switch-style load balance and router z-loss, returned as
metrics. The load balance multiplies two means over the tokens, so a step
whose ranks each hold a share of the batch takes them over every token
(``token_mean``, which the sharded train step passes). The expert products
are batched GEMMs (``torch.bmm``), as the reference's are einsums outside
any Pallas kernel. Every cast below is a rounding point of the reference
and is kept.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import ParamSpec


def _id_shard(x, names):
    """The default ``shard`` hook: no layout to impose."""
    return x


def moe_specs(cfg: ModelConfig):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    sp = {
        "router": ParamSpec((d, E), ("embed", "expert"), "normal", 0.02),
        "w_gate": ParamSpec((E, d, ff), ("expert", "embed", "expert_mlp")),
        "w_up": ParamSpec((E, d, ff), ("expert", "embed", "expert_mlp")),
        "w_down": ParamSpec((E, ff, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        sp["shared"] = {
            "w_gate": ParamSpec((d, ff * cfg.n_shared_experts), ("embed", "mlp")),
            "w_up": ParamSpec((d, ff * cfg.n_shared_experts), ("embed", "mlp")),
            "w_down": ParamSpec((ff * cfg.n_shared_experts, d), ("mlp", "embed")),
        }
    return sp


def _router(cfg: ModelConfig, p, x,
            token_mean: Optional[Callable] = None):
    """x (B,S,d) -> (weights (B,S,k) f32, idx (B,S,k), aux dict).
    ``token_mean`` turns this rank's mean over its tokens into the mean
    over every rank's (equal token counts; differentiable), where each
    rank holds a share of the batch; None: the batch is whole here."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    k = cfg.num_experts_per_tok
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, k, dim=-1)
    w = w / torch.sum(w, -1, keepdim=True)

    E = cfg.num_experts
    me = torch.mean(gates, dim=(0, 1))                            # mean gate
    ce = torch.mean(F.one_hot(idx[..., 0], E).to(torch.float32),
                    dim=(0, 1))                                   # top-1 freq
    if token_mean is not None:
        me, ce = token_mean(me), token_mean(ce)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return w, idx, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _swiglu(x, w_gate, w_up, w_down, mm):
    """SwiGLU with the gate's silu in f32, cast back before ``* u``."""
    g = mm(x, w_gate.to(x.dtype))
    u = mm(x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return mm(h, w_down.to(x.dtype))


def _expert_ffn_grouped(p, x):
    """x (E, G, C, d) -> (E, G, C, d), per-expert SwiGLU as batched GEMMs
    over each expert's G * C rows."""
    E, G, C, d = x.shape
    y = _swiglu(x.reshape(E, G * C, d), p["w_gate"], p["w_up"], p["w_down"],
                torch.bmm)
    return y.reshape(E, G, C, d)


def _shared_expert(p, x):
    return _swiglu(x, p["w_gate"], p["w_up"], p["w_down"], torch.matmul)


def moe_block_dense(cfg: ModelConfig, p, x, *,
                    token_mean: Optional[Callable] = None):
    """All experts on all tokens (smoke-scale only)."""
    w, idx, aux = _router(cfg, p, x, token_mean=token_mean)
    E = cfg.num_experts
    comb = torch.sum(F.one_hot(idx, E).to(torch.float32) * w[..., None],
                     dim=2)                                       # (B,S,E)
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    y = torch.einsum("bsef,efd->bsed", h, p["w_down"].to(x.dtype))
    out = torch.einsum("bsed,bse->bsd", y.to(torch.float32), comb).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p["shared"], x)
    return out, aux


def dispatch_geometry(cfg: ModelConfig, tokens: int, capacity_factor: float,
                      groups: int = 0):
    """(groups, tokens a group Sg, slots a (group, expert) C): groups
    default to min(tokens, 256) and are lowered until they divide the
    tokens; C = cf * Sg * k / E rounded up to a multiple of 4, at least 4,
    at most Sg * k."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    if groups <= 0:
        groups = min(tokens, 256)
    while tokens % groups:
        groups -= 1
    Sg = tokens // groups
    C = max(4, -(-int(capacity_factor * Sg * k / E) // 4) * 4)
    return groups, Sg, min(C, Sg * k)


def dispatch_slots(ig, E: int):
    """Each (token, choice)'s slot within its (group, expert): first come
    first served by (token, choice), from an exclusive running count over
    the group's flattened Sg * k choices. ig (G, Sg, k) -> (G, Sg, k)."""
    G, Sg, k = ig.shape
    mask = F.one_hot(ig.reshape(G, Sg * k), E)                # (G,Sg*k,E)
    pos = torch.cumsum(mask, dim=1) - mask                    # exclusive
    return torch.sum(pos * mask, dim=-1).reshape(G, Sg, k)


def moe_block_dispatch(cfg: ModelConfig, p, x, *,
                       capacity_factor: float = 1.25,
                       shard: Callable = _id_shard, groups: int = 0,
                       token_mean: Optional[Callable] = None):
    """Capacity-bounded dispatch with token groups: tokens are flattened to
    (G, Sg, d); capacity is per (group, expert), C = cf * Sg * k / E;
    over-capacity choices drop (the token keeps its residual).

    The (E, G, C, d) expert input is gathered from the tokens (a slot no
    choice fills reads a zero row), and each kept choice gathers its
    expert's output back, weighted by its gate rounded to ``x.dtype``, the
    k products summed in f32 and rounded once, as the reference's combine
    contraction does. Every shape is fixed by the config and the token
    count, never by the routing, so a recomputation under
    ``torch.utils.checkpoint`` saves the same tensors."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G, Sg, C = dispatch_geometry(cfg, B * S, capacity_factor, groups)

    w, idx, aux = _router(cfg, p, x, token_mean=token_mean)   # (B,S,k) x2
    x_grp = shard(x.reshape(G, Sg, d), ("tokens", None, None))
    ig = idx.reshape(G, Sg, k)
    slot = dispatch_slots(ig, E)
    keep = slot < C

    # the flat slot of each kept (token, choice) in the (E, G, C) buffer;
    # dropped choices point past its end
    g_of = torch.arange(G, device=x.device)[:, None, None]
    dest = torch.where(keep, (ig * G + g_of) * C + slot, E * G * C)
    src = torch.full((E * G * C + 1,), G * Sg, dtype=torch.long,
                     device=x.device)
    tok = torch.arange(G * Sg, device=x.device).reshape(G, Sg, 1)
    src.scatter_(0, dest.reshape(-1), tok.expand(G, Sg, k).reshape(-1))
    xg = torch.cat([x_grp.reshape(G * Sg, d), x.new_zeros(1, d)])
    expert_in = shard(xg[src[:-1]].reshape(E, G, C, d),
                      ("expert", "tokens", None, None))

    eo = shard(_expert_ffn_grouped(p, expert_in),
               ("expert", "tokens", None, None)).reshape(E * G * C, d)
    eo = torch.cat([eo, eo.new_zeros(1, d)])
    picked = eo[dest]                                         # (G,Sg,k,d)
    wk = torch.where(keep, w.reshape(G, Sg, k), 0.0).to(x.dtype)
    out = torch.sum(picked.to(torch.float32)
                    * wk.to(torch.float32)[..., None], dim=2)
    out = shard(out.to(x.dtype), ("tokens", None, None)).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + _shared_expert(p["shared"], x)
    return out, aux


def moe_block(cfg: ModelConfig, p, x, *, path: str = "dispatch",
              shard: Callable = _id_shard, groups: int = 0,
              token_mean: Optional[Callable] = None):
    if path == "dense":
        return moe_block_dense(cfg, p, x, token_mean=token_mean)
    return moe_block_dispatch(cfg, p, x, shard=shard, groups=groups,
                              token_mean=token_mean)
