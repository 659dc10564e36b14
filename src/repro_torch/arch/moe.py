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

Expert parallelism: with ``tp`` (a ``distributed.sharding.TPContext``) the
block takes one rank's expert shards, read from the weights' shapes. The
ranks of the ``model`` axis hold the same rows, so each routes all of them
with the same router and slots (the kept and dropped choices are the
unsharded ones) and computes only its part of the expert sum: its
``E / tp`` experts ``[r E/tp, (r+1) E/tp)`` (``w_gate`` shorter than E,
the reference's EP) or, where E does not divide the model extent, every
expert on its ``d_ff / tp`` columns (``expert_mlp`` over ``model``). Its
kept choices' products, gathered back and weighted, are a partial f32
combine; one sum over ``model`` (an all-reduce, or under sequence
parallelism a reduce-scatter) then one rounding to ``x.dtype`` give the
unsharded combine up to the order of the f32 sum. Under the serving rules
the columns are also split over the data axes (``TPContext.expert_dp``:
2D expert shards, weights stationary), whose ranks hold other rows: the
expert buffer's groups are all-gathered over them before the products and
the partial outputs reduce-scattered back. No all-to-all. The shared
expert splits its columns as the dense MLP does and is added after the
rounding. Every rank holds the whole gates and aux losses: the gates (and,
under sequence parallelism, the router's input) pass into the sharded part
so that the router's gradient is whole and equal on every rank. Where the
rules split no expert dim, the block computes whole on every rank, as the
model's other whole-weight parts do (a Mamba2 mixer or an RWKV6 part
that takes the guard: ``launch/cells.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import copy_in, gather, scatter
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
                    token_mean: Optional[Callable] = None, tp=None):
    """All experts on all tokens (smoke-scale only). With ``tp``, this
    rank's experts or columns over ``model`` (not the data-axis columns of
    the serving rules)."""
    io = _EPBlock(cfg, p, x, tp)
    if io.expert_dp:
        raise ValueError("the dense MoE path takes no data-axis expert "
                         "shards (serve with the dispatch path)")
    x = io.x
    w, idx, aux = _router(cfg, p, io.router_in, token_mean=token_mean)
    w = io.gates(w)
    E = cfg.num_experts
    comb = torch.sum(F.one_hot(idx, E).to(torch.float32) * w[..., None],
                     dim=2)                                       # (B,S,E)
    comb = comb[..., io.e0:io.e0 + io.el]
    xe = io.experts_in
    g = torch.einsum("bsd,edf->bsef", xe, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,edf->bsef", xe, p["w_up"].to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    y = torch.einsum("bsef,efd->bsed", h, p["w_down"].to(x.dtype))
    out = io.routed(torch.einsum("bsed,bse->bsd", y.to(torch.float32),
                                 comb))
    if cfg.n_shared_experts:
        out = out + io.shared(_shared_expert)
    return out, aux


class _EPBlock:
    """How one rank's MoE block meets the residual stream (see the
    module's docstring): the router's input and the experts' (``x`` whole
    along the sequence), the rank's experts ``[e0, e0 + el)``, whether its
    routed output is a part of a sum over ``model`` (``split``), and the
    data-axis column groups (``expert_dp``). Without ``tp`` every method
    is the identity and the block is the unsharded one."""

    def __init__(self, cfg: ModelConfig, p, x, tp):
        self.cfg, self.p, self.tp = cfg, p, tp
        E = cfg.num_experts
        self.el = p["w_gate"].shape[0]
        self.e0, self.expert_dp = 0, ()
        self.split = self.shared_split = False
        self.x = x
        self.router_in = self.experts_in = self.shared_in = x
        if tp is None:
            return
        self.expert_dp = tuple(tp.expert_dp)
        dp = math.prod(n for _, n in self.expert_dp)
        if self.el < E:
            if self.el * tp.tp != E:
                raise ValueError(f"{self.el} of {E} experts on a model axis "
                                 f"of {tp.tp}")
            self.e0 = tp.rank * self.el
        cols = p["w_gate"].shape[-1] * dp < cfg.d_ff
        self.split = self.el < E or cols
        self.shared_split = bool(cfg.n_shared_experts) and \
            p["shared"]["w_down"].shape[0] < cfg.d_ff * cfg.n_shared_experts
        if tp.seq:
            # the sequence gathered (its gradient summed back over the
            # ranks): the router, which every rank repeats, passes a
            # tp-th of its gradient
            self.x = self.experts_in = self.shared_in = tp.enter(x, True)
            self.router_in = tp.repeated(self.x)
            return
        into = tp.enter(x, True) if self.split or self.shared_split else x
        self.experts_in = into if self.split else x
        self.shared_in = into if self.shared_split else x

    def gates(self, w):
        """The gates as the sharded part reads them: its gradient, a part
        over the ranks' choices (or sequence shards), summed over
        ``model``."""
        if self.tp is None or not (self.split or self.tp.seq):
            return w
        return copy_in(w, self.tp.model, self.tp.tp)

    def groups_in(self, t):
        """The expert buffer's groups (dim 1) of every data-axis rank."""
        for group, n in self.expert_dp:
            t = gather(t, 1, group, n)
        return t

    def groups_out(self, t):
        """The partial products summed over the data axes, this rank's
        groups kept."""
        for group, n in reversed(self.expert_dp):
            t = scatter(t, 1, group, n)
        return t

    def routed(self, out32, shape=None):
        """The f32 combine (a part of the sum where ``split``) summed over
        ``model`` and, as ``shape`` (B, S, d), back in the residual
        stream's layout, rounded once to ``x.dtype``."""
        if self.tp is not None:
            out32 = self.tp.leave(out32.reshape(shape or out32.shape),
                                  self.split)
        return out32.to(self.x.dtype)

    def shared(self, fn):
        """The shared expert on its column shards, its partial sums
        reduced (or whole)."""
        out = fn(self.p["shared"], self.shared_in)
        if self.tp is not None:
            out = self.tp.leave(out, self.shared_split)
        return out


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
                       token_mean: Optional[Callable] = None, tp=None):
    """Capacity-bounded dispatch with token groups: tokens are flattened to
    (G, Sg, d); capacity is per (group, expert), C = cf * Sg * k / E;
    over-capacity choices drop (the token keeps its residual).

    The (E, G, C, d) expert input is gathered from the tokens (a slot no
    choice fills reads a zero row), and each kept choice gathers its
    expert's output back, weighted by its gate rounded to ``x.dtype``, the
    k products summed in f32 and rounded once, as the reference's combine
    contraction does. Every shape is fixed by the config and the token
    count, never by the routing, so a recomputation under
    ``torch.utils.checkpoint`` saves the same tensors. With ``tp`` the
    buffer holds this rank's experts only (see the module's docstring)."""
    io = _EPBlock(cfg, p, x, tp)
    x = io.x
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    e0, el = io.e0, io.el
    G, Sg, C = dispatch_geometry(cfg, B * S, capacity_factor, groups)

    w, idx, aux = _router(cfg, p, io.router_in,
                          token_mean=token_mean)              # (B,S,k) x2
    w = io.gates(w)
    x_grp = shard(io.experts_in.reshape(G, Sg, d), ("tokens", None, None))
    ig = idx.reshape(G, Sg, k)
    slot = dispatch_slots(ig, E)
    keep = slot < C
    if el < E:                          # the choices of this rank's experts
        keep = keep & (ig >= e0) & (ig < e0 + el)

    # the flat slot of each kept (token, choice) in the (el, G, C) buffer;
    # dropped choices, and other ranks' experts, point past its end
    g_of = torch.arange(G, device=x.device)[:, None, None]
    dest = torch.where(keep, ((ig - e0) * G + g_of) * C + slot, el * G * C)
    src = torch.full((el * G * C + 1,), G * Sg, dtype=torch.long,
                     device=x.device)
    tok = torch.arange(G * Sg, device=x.device).reshape(G, Sg, 1)
    src.scatter_(0, dest.reshape(-1), tok.expand(G, Sg, k).reshape(-1))
    xg = torch.cat([x_grp.reshape(G * Sg, d), x.new_zeros(1, d)])
    expert_in = shard(xg[src[:-1]].reshape(el, G, C, d),
                      ("expert", "tokens", None, None))

    eo = io.groups_out(_expert_ffn_grouped(p, io.groups_in(expert_in)))
    eo = shard(eo, ("expert", "tokens", None, None)).reshape(el * G * C, d)
    eo = torch.cat([eo, eo.new_zeros(1, d)])
    picked = eo[dest]                                         # (G,Sg,k,d)
    wk = torch.where(keep, w.reshape(G, Sg, k), 0.0).to(x.dtype)
    out = torch.sum(picked.to(torch.float32)
                    * wk.to(torch.float32)[..., None], dim=2)
    out = shard(io.routed(out, (B, S, d)),
                ("tokens", None, None)).reshape(B, -1, d)
    if cfg.n_shared_experts:
        out = out + io.shared(_shared_expert)
    return out, aux


def moe_block(cfg: ModelConfig, p, x, *, path: str = "dispatch",
              shard: Callable = _id_shard, groups: int = 0,
              token_mean: Optional[Callable] = None, tp=None):
    if path == "dense":
        return moe_block_dense(cfg, p, x, token_mean=token_mean, tp=tp)
    return moe_block_dispatch(cfg, p, x, shard=shard, groups=groups,
                              token_mean=token_mean, tp=tp)
