"""Train / serve step builders shared by the launcher and the tests.

``make_train_step(cfg)`` -> f(params, opt_state, batch) -> (params,
opt_state, metrics), with optional gradient accumulation (microbatching,
summed in f32) and a gradient post-processing hook. The parameters are
plain tensors that need not require grad: the step differentiates
``train_loss`` with respect to fresh leaves that share their storage.
``shard`` is the model's layout hook (``distributed.sharding.make_shard_fn``)
and ``scan_unroll`` the reference's scan unroll, which changes no result
(``arch/model.py``). ``tp`` (a ``distributed.sharding.TPContext``: the
model axis's group, this rank's place on it, sequence parallelism and the
FSDP gathers) makes the gradient, prefill and decode functions compute on
one rank's shards (``launch/cells.py`` builds it); without it they are
the unsharded functions.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..arch import model as M
from ..arch.params import cast_tree, tree_leaves
from ..configs.base import ModelConfig
from .optim import AdamWConfig, apply_update

_ID = M._id_shard

def _unflatten(like, leaves):
    """A tree of ``like``'s structure from leaves in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def make_grad_fn(cfg: ModelConfig, *, shard: Callable = _ID,
                 remat: bool = True, moe_path: str = "dispatch",
                 scan_unroll=1, moe_groups: int = 0,
                 cast_params_bf16: bool = False,
                 token_mean: Optional[Callable] = None, tp=None):
    """Returns grads(params, micro_batches) -> (gradients as a list in
    ``tree_leaves`` order, metrics): one batch's gradients of
    ``train_loss``, or, for more than one microbatch, their f32 sum over
    the microbatches divided by their count and the metrics' means.
    ``token_mean`` reaches the MoE routers (``arch.model.forward``);
    with ``tp`` the gradients are those of this rank's shards, each
    period's FSDP shards reduce-scattered over the data axes."""
    def single(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        tree = _unflatten(params, live)
        with torch.enable_grad():
            if cast_params_bf16:
                tree = cast_tree(tree, torch.bfloat16)
            loss, metrics = M.train_loss(cfg, tree, batch, shard=shard,
                                         remat=remat, moe_path=moe_path,
                                         scan_unroll=scan_unroll,
                                         moe_groups=moe_groups,
                                         token_mean=token_mean, tp=tp)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grads(params, micro_batches):
        if len(micro_batches) == 1:
            return single(params, micro_batches[0])
        acc, mets = None, []
        for batch in micro_batches:
            g, metrics = single(params, batch)
            g = [x.to(torch.float32) for x in g]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            mets.append(metrics)
        metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                   for k in mets[0]}
        return [g / len(micro_batches) for g in acc], metrics

    return grads


def make_train_step(cfg: ModelConfig, *, opt: AdamWConfig = AdamWConfig(),
                    shard: Callable = _ID, remat: bool = True,
                    moe_path: str = "dispatch", microbatches: int = 1,
                    grad_hook: Optional[Callable] = None,
                    scan_unroll=1, moe_groups: int = 0,
                    cast_params_bf16: bool = False):
    """Returns train_step(params, opt_state, batch).

    cast_params_bf16: cast the f32 master params to bf16 before the
    forward; the gradients still flow to the f32 masters through the cast.
    ``moe_path`` ("dispatch" or "dense") and ``moe_groups`` reach the MoE
    blocks; the metrics carry their aux losses. Microbatches are laid out
    as (mb, B/mb, ...) and each handed to ``shard`` with its batch dim
    named (``_reshard_micro``), as the reference does."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    grad_fn = make_grad_fn(cfg, shard=shard, remat=remat, moe_path=moe_path,
                           scan_unroll=scan_unroll, moe_groups=moe_groups,
                           cast_params_bf16=cast_params_bf16)

    def _reshard_micro(x):
        if x.dim() == 4 and x.shape[1] == 3:
            return shard(x, (None, None, "batch", None))
        return shard(x, (None, "batch") + (None,) * (x.dim() - 2))

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            mb = {k: _reshard_micro(to_micro(batch[k], microbatches))
                  for k in sorted(batch)}
            micro = [{k: x[i] for k, x in mb.items()}
                     for i in range(microbatches)]
        else:
            micro = [batch]
        grads, metrics = grad_fn(params, micro)
        grads = _unflatten(params, grads)
        if grad_hook is not None:
            grads = grad_hook(grads)
        params, opt_state, opt_metrics = apply_update(params, grads,
                                                      opt_state, opt)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def to_micro(x, microbatches: int):
    """(B, ...) -> (mb, B/mb, ...); M-RoPE positions (3, B, S) keep their
    leading 3 inside each microbatch: (3, B, S) -> (mb, 3, B/mb, S)."""
    if x.dim() == 3 and x.shape[0] == 3:
        return x.reshape(3, microbatches, -1, x.shape[2]).transpose(0, 1)
    return x.reshape((microbatches, -1) + tuple(x.shape[1:]))


def make_prefill_step(cfg: ModelConfig, *, shard: Callable = _ID,
                      moe_path: str = "dispatch", moe_groups: int = 0,
                      tp=None, cache=True):
    def prefill(params, batch):
        return M.forward(cfg, params, batch, mode="prefill", shard=shard,
                         remat=False, moe_path=moe_path,
                         moe_groups=moe_groups, tp=tp, cache=cache)
    return prefill


def make_decode_step(cfg: ModelConfig, *, shard: Callable = _ID,
                     moe_path: str = "dispatch", scan_unroll=1,
                     moe_groups: int = 0, attn_dist=None, tp=None):
    def decode(params, state, batch):
        return M.decode_step(cfg, params, state, batch, shard=shard,
                             moe_path=moe_path, scan_unroll=scan_unroll,
                             moe_groups=moe_groups, attn_dist=attn_dist,
                             tp=tp)
    return decode
