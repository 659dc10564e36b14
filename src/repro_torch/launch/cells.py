"""Build one cell: (arch x input shape x mesh) -> the step under its
shardings + meta-device args. Shared by the dry run (``launch/dryrun.py``)
and the sharded training and serving runs.

The twin of ``repro.launch.cells``, whose ``jax.jit(step, in_shardings=,
out_shardings=)`` lets XLA partition the model over the mesh. Here the
kernels take whole, contiguous plain tensors, so a cell's ``fn`` does no
tensor-parallel math: it takes DTensors at the rules' placements and

  1. gathers the parameters whole on every rank (the FSDP all-gathers
     that the placements imply), and takes this rank's rows of the batch;
  2. runs the port's unsharded step on those plain tensors;
  3. for training, averages the gradients over every rank of the mesh,
     runs ``grad_hook`` on them there (where the reference's runs), cuts
     them to the parameters' placements, takes the clip's global norm over
     the distinct shards (a shard replicated on a mesh dim counts once),
     and runs AdamW on each rank's shards; the moments shard like the
     parameters and the step count is replicated;
  4. returns DTensors at the placements it was given (outputs that carry
     a batch dim: split over the ranks that split the batch).

A training step's rows are spread over every rank of the mesh, the model
axis too, where the batch divides: each microbatch's B/mb rows over
gcd(ranks, B/mb) slices, consecutive ranks sharing a slice. Prefill and
decode keep the batch placement's rows (``batch_shardings``: the
data-parallel axes). Every rank of a slice holds the same number of
tokens, so the mean of the ranks' mean losses is the batch's. MoE token
groups stay the reference's (``moe_groups`` = the mesh size over the
global batch): a rank runs its rows' share of them, and the router's
load-balance means are taken over every rank's tokens (the ``token_mean``
it passes to the routers). The result equals the unsharded step's on the
global batch, up to the order of the sums.

``lower_cell`` has no twin: nothing is lowered to XLA here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..arch import model as M
from ..arch.moe import dispatch_geometry
from ..arch.params import shape_structs, tree_leaves
from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..data.synthetic import input_specs_for
from ..distributed.checkpoint import tree_map
from ..distributed.sharding import (Rules, as_local, baseline_rules,
                                    batch_shardings, contiguous_stride,
                                    decode_state_shardings,
                                    holds_distinct, local_block, make_shard_fn,
                                    mesh_mean_autograd, mesh_sum,
                                    param_shardings, rows_only,
                                    sharded_extent, whole)
from ..launch.mesh import dp_axes
from ..train import AdamWConfig, state_specs
from ..train.optim import AdamWState, apply_update
from ..train.step import (_unflatten, make_decode_step, make_grad_fn,
                          make_prefill_step)


@dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: Any
    rules: Rules
    fn: Callable            # the step under its shardings
    args: Tuple             # meta-device tensors
    kind: str
    microbatches: int = 1
    remat: bool = True
    dist_decode: bool = False
    cast_params_bf16: bool = False
    moe_path: str = "dispatch"


def _extent(mesh, axes) -> int:
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.shape[names.index(a)] for a in axes if a in names)


def auto_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      budget_bytes: float = 4 * 2**30) -> int:
    """Gradient-accumulation factor so the per-device remat residual stack
    (num_periods x B_loc x S x d x 2 bytes) fits the activation budget."""
    dp = _extent(mesh, ("pod", "data"))
    b_loc = max(1, shape.global_batch // dp)
    stack = cfg.num_periods * b_loc * shape.seq_len * cfg.d_model * 2
    mb = 1
    while stack / mb > budget_bytes and mb * 2 <= b_loc \
            and shape.global_batch % (mb * 2) == 0:
        mb *= 2
    return mb


def train_split(mesh, rows: int) -> int:
    """How many slices a training microbatch of ``rows`` rows is cut into:
    gcd(ranks of the mesh, rows); ``mesh.size() // split`` consecutive
    ranks share a slice."""
    return math.gcd(mesh.size(), rows)


def _is_moe(cfg: ModelConfig) -> bool:
    return "attn_moe" in cfg.pattern


def local_moe_groups(cfg: ModelConfig, tokens: int, groups: int,
                     split: int) -> int:
    """The token groups of one rank's share when ``tokens`` (a global
    microbatch) are cut into ``split`` equal slices: the reference's
    groups over all of them (``dispatch_geometry``), ``split`` to a
    slice, so every group keeps its tokens."""
    if not _is_moe(cfg):
        return groups
    g = dispatch_geometry(cfg, tokens, 1.25, groups)[0]
    if g % split:
        raise ValueError(f"{g} MoE token groups do not split over {split} "
                         "slices of the batch")
    return g // split


def _flat_rank(mesh) -> int:
    flat = 0
    for c, n in zip(mesh.get_coordinate(), mesh.shape):
        flat = flat * n + c
    return flat


def _batch_dim(key: str) -> int:
    return 1 if key == "positions" else 0         # M-RoPE (3, B, S)


def make_sharded_train_step(cfg: ModelConfig, mesh, rules: Rules, *,
                            opt: AdamWConfig = AdamWConfig(),
                            remat: bool = True, moe_path: str = "dispatch",
                            microbatches: int = 1,
                            grad_hook: Optional[Callable] = None,
                            scan_unroll=1, moe_groups: int = 0,
                            cast_params_bf16: bool = False):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) on ``mesh``: params and the AdamW moments DTensors (at
    ``param_shardings``), the step count a replicated DTensor, the batch
    DTensors at ``batch_shardings`` or plain tensors whole on every rank.
    Every rank of the mesh calls it (see the module's docstring)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    shard = make_shard_fn(mesh, rules)
    n = mesh.size()
    f32 = torch.float32
    # the router's means over every rank's tokens
    token_mean = (lambda m: mesh_mean_autograd(m, mesh)) \
        if _is_moe(cfg) else None

    def step(params, opt_state, batch):
        batch = {k: whole(x) for k, x in sorted(batch.items())}
        B, S = batch["labels"].shape
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             "microbatches")
        rows = B // microbatches
        split = train_split(mesh, rows)
        per = rows // split
        k = _flat_rank(mesh) // (n // split)
        micro = [{key: x.narrow(_batch_dim(key), i * rows + k * per, per)
                  for key, x in batch.items()} for i in range(microbatches)]
        for mb in micro:              # each rank holds the same token count
            assert mb["labels"].shape == (per, S), mb["labels"].shape
        grad_fn = make_grad_fn(
            cfg, shard=shard, remat=remat, moe_path=moe_path,
            scan_unroll=scan_unroll,
            moe_groups=local_moe_groups(cfg, rows * S, moe_groups, split),
            cast_params_bf16=cast_params_bf16, token_mean=token_mean)
        full = tree_map(lambda p: whole(p).detach(), params)
        grads, metrics = grad_fn(full, micro)
        del full
        # the mean over every rank's rows (ranks sharing a slice hold equal
        # gradients), in place, then the hook on the whole gradients
        grads = [mesh_sum(g, mesh).div_(n) for g in grads]
        metrics = {key: mesh_sum(v.clone(), mesh) / n
                   for key, v in metrics.items()}
        grads = _unflatten(params, grads)
        if grad_hook is not None:
            grads = grad_hook(grads)
        p_leaves = tree_leaves(params)
        g_local = [local_block(g, p.device_mesh, p.placements)
                   for g, p in zip(tree_leaves(grads), p_leaves)]
        del grads
        # the clip's global norm: each distinct shard once, then the sum
        # over the mesh
        sq = sum(torch.sum(torch.square(g.to(f32)))
                 if holds_distinct(p, mesh) else torch.zeros((), dtype=f32,
                                                             device=g.device)
                 for g, p in zip(g_local, p_leaves))
        gnorm = torch.sqrt(mesh_sum(sq, mesh))
        local = lambda t: t.to_local()            # noqa: E731
        state = AdamWState(local(opt_state.step),
                           tree_map(local, opt_state.mu),
                           tree_map(local, opt_state.nu))
        new_p, new_s, opt_metrics = apply_update(
            tree_map(local, params), _unflatten(params, g_local), state, opt,
            gnorm=gnorm)
        out_state = AdamWState(as_local(new_s.step, opt_state.step),
                               _wrap(new_s.mu, opt_state.mu),
                               _wrap(new_s.nu, opt_state.nu))
        return _wrap(new_p, params), out_state, {**metrics, **opt_metrics}

    return step


def _wrap(new, like):
    """A dict tree of this rank's blocks as DTensors placed like ``like``'s
    leaves."""
    if isinstance(new, dict):
        return {k: _wrap(new[k], like[k]) for k in new}
    return as_local(new, like)


def _rows_placements(mesh, like_pls, dim: int) -> tuple:
    """The placements of a batch-shaped output whose rows (dim ``dim``)
    are split as the batch leaf's (``like_pls``, its rows on dim 0)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dim) if isinstance(pl, Shard) else Replicate()
                 for pl in like_pls)


def _local_batch(mesh, rules: Rules, batch):
    """This rank's rows of each batch leaf (at ``batch_shardings``) and
    the placements of the tokens' rows."""
    from torch.distributed.tensor import DTensor
    specs = {k: M.TensorSpec(tuple(x.shape), x.dtype)
             for k, x in batch.items()}
    shardings = batch_shardings(mesh, rules, specs)
    out = {}
    for key, x in batch.items():
        _, pls = shardings[key]
        if isinstance(x, DTensor):
            x = x.redistribute(mesh, pls).to_local()
        else:
            x = local_block(x, mesh, pls)
        out[key] = x
    return out, shardings["tokens" if "tokens" in batch else "frames"][1]


def make_sharded_prefill_step(cfg: ModelConfig, mesh, rules: Rules, *,
                              moe_path: str = "dispatch",
                              moe_groups: int = 0):
    """Returns prefill(params, batch) -> (logits, decode state) on
    ``mesh``: the params gathered whole, this rank's rows of the batch (at
    ``batch_shardings``), the outputs DTensors with their rows where the
    batch's are."""
    from torch.distributed.tensor import DTensor
    shard = make_shard_fn(mesh, rules)

    def prefill(params, batch):
        local, row_pls = _local_batch(mesh, rules, batch)
        split = sharded_extent(mesh, row_pls)
        B, S = batch["tokens" if "tokens" in batch else "frames"].shape[:2]
        groups = local_moe_groups(cfg, B * S, moe_groups, split)
        full = tree_map(whole, params)
        logits, state = make_prefill_step(
            cfg, shard=shard, moe_path=moe_path, moe_groups=groups)(
                full, local)

        def out(t, dim):
            pls = _rows_placements(mesh, row_pls, dim)
            shape = list(t.shape)
            shape[dim] *= split
            return DTensor.from_local(t, mesh, pls, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=contiguous_stride(shape))
        state = {"caches": tree_map(lambda t: out(t, 1), state["caches"]),
                 "lengths": out(state["lengths"], 0)}
        return out(logits, 0), state

    return prefill


def make_sharded_decode_step(cfg: ModelConfig, mesh, rules: Rules, *,
                             moe_path: str = "dispatch", scan_unroll=1,
                             moe_groups: int = 0, dist_decode: bool = False):
    """Returns decode(params, state, batch) -> (logits, state) on
    ``mesh``: the params gathered whole; the state's leaves DTensors at
    ``decode_state_shardings`` (or plain, whole on every rank), each
    gathered to this rank's rows over every non-data-parallel mesh dim,
    except, with ``dist_decode``, the k/v caches, which stay sequence
    shards and attend through the distributed flash-decode; the new state
    at the state's placements (its k/v chunks written in place, as the
    reference donates the state)."""
    from torch.distributed.tensor import DTensor
    shard = make_shard_fn(mesh, rules)
    attn_dist = {"mesh": mesh, "seq_axis": "model",
                 "batch_axes": dp_axes(mesh)} if dist_decode else None

    def decode(params, state, batch):
        local_b, row_pls = _local_batch(mesh, rules, batch)
        split = sharded_extent(mesh, row_pls)
        B = batch["tokens"].shape[0]
        specs = tree_map(lambda x: M.TensorSpec(tuple(x.shape), x.dtype),
                         state)
        targets = decode_state_shardings(mesh, rules, cfg, specs)

        def take(path, x, target):
            _, pls = target
            if not isinstance(x, DTensor):
                x = DTensor.from_local(local_block(x, mesh, pls), mesh, pls,
                                       run_check=False, shape=x.shape,
                                       stride=x.stride())
            if dist_decode and path in ("k", "v"):
                return x.to_local()
            return x.redistribute(mesh, rows_only(mesh, pls)).to_local()

        def back(path, t, like, target):
            _, pls = target
            if dist_decode and path in ("k", "v"):
                return DTensor.from_local(t, mesh, pls, run_check=False,
                                          shape=like.shape,
                                          stride=like.stride())
            return DTensor.from_local(
                t, mesh, rows_only(mesh, pls), run_check=False,
                shape=like.shape,
                stride=like.stride()).redistribute(mesh, pls)

        local_s = _walk(take, state, targets)
        full = tree_map(whole, params)
        logits, new = make_decode_step(
            cfg, shard=shard, moe_path=moe_path, scan_unroll=scan_unroll,
            moe_groups=local_moe_groups(cfg, B, moe_groups, split),
            attn_dist=attn_dist)(full, local_s, local_b)
        new = _walk(back, new, state, targets)
        pls = _rows_placements(mesh, row_pls, 0)
        shape = (B,) + tuple(logits.shape[1:])
        return DTensor.from_local(logits, mesh, pls, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape)), new

    return decode


def _walk(f, tree, *others, path: str = ""):
    """``f(leaf name, leaf, the others' leaves...)`` over a dict tree and
    its twins."""
    if isinstance(tree, dict):
        return {k: _walk(f, v, *(o[k] for o in others), path=k)
                for k, v in tree.items()}
    return f(path, tree, *others)


def _structs(tree):
    """``TensorSpec`` leaves as meta-device tensors."""
    if isinstance(tree, M.TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _structs(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_structs(t) for t in tree))
    return tree


def build_cell(arch: Union[str, ModelConfig],
               shape_name: Union[str, ShapeSpec], mesh, *,
               rules: Optional[Rules] = None,
               opt: AdamWConfig = AdamWConfig(),
               moe_path: str = "dispatch",
               remat: bool = True,
               microbatches: int = 0,
               scan_unroll=1,
               serve_dtype: str = "bfloat16",
               dist_decode: bool = False,
               cast_params_bf16: bool = False,
               grad_hook: Optional[Callable] = None,
               extra: Optional[dict] = None) -> Cell:
    """``arch`` (a config name, or a ``ModelConfig``) at ``shape_name`` (a
    ``SHAPES`` key or a ``ShapeSpec``) on ``mesh`` (a ``DeviceMesh``, or a ``MeshShape`` for
    accounting only: its ``fn`` cannot run). ``args`` are meta tensors:
    (params, AdamW state, batch) for training, (params, batch) for
    prefill, (params, decode state, batch) for decode."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    multi_pod = "pod" in tuple(mesh.mesh_dim_names)
    rules = rules or baseline_rules(multi_pod)
    if microbatches == 0:           # auto-size gradient accumulation
        microbatches = (auto_microbatches(cfg, shape, mesh)
                        if shape.kind == "train" else 1)
    groups = mesh.size()
    pspecs = M.build_param_specs(cfg)
    in_batch = _structs(input_specs_for(cfg, shape))

    if shape.kind == "train":
        params = shape_structs(pspecs, getattr(torch, cfg.param_dtype))
        ostate = _structs(state_specs(pspecs, opt))
        fn = make_sharded_train_step(
            cfg, mesh, rules, opt=opt, remat=remat, moe_path=moe_path,
            microbatches=microbatches, grad_hook=grad_hook,
            scan_unroll=scan_unroll, moe_groups=groups,
            cast_params_bf16=cast_params_bf16)
        args = (params, ostate, in_batch)
    elif shape.kind == "prefill":
        params = shape_structs(pspecs, getattr(torch, serve_dtype))
        fn = make_sharded_prefill_step(cfg, mesh, rules, moe_path=moe_path,
                                       moe_groups=groups)
        args = (params, in_batch)
    else:  # decode
        params = shape_structs(pspecs, getattr(torch, serve_dtype))
        dstate = _structs(M.decode_state_specs(
            cfg, shape.global_batch, shape.seq_len,
            getattr(torch, serve_dtype)))
        fn = make_sharded_decode_step(cfg, mesh, rules, moe_path=moe_path,
                                      scan_unroll=scan_unroll,
                                      moe_groups=groups,
                                      dist_decode=dist_decode)
        args = (params, dstate, in_batch)
    return Cell(cfg=cfg, shape=shape, mesh=mesh, rules=rules, fn=fn,
                args=args, kind=shape.kind, microbatches=microbatches,
                remat=remat, dist_decode=dist_decode,
                cast_params_bf16=cast_params_bf16, moe_path=moe_path)


def cell_shardings(cell: Cell):
    """The placements of ``cell.args``, as ``(mesh, placements)`` trees:
    params and moments at ``param_shardings``, the step count replicated,
    the batch at ``batch_shardings``, a decode state at
    ``decode_state_shardings``."""
    from torch.distributed.tensor import Replicate
    mesh, rules = cell.mesh, cell.rules
    p_shard = param_shardings(mesh, rules, M.build_param_specs(cell.cfg))
    spec_of = lambda t: M.TensorSpec(tuple(t.shape), t.dtype)  # noqa: E731
    b_shard = batch_shardings(mesh, rules, {k: spec_of(t) for k, t in
                                            cell.args[-1].items()})
    if cell.kind == "train":
        o_shard = AdamWState(step=(mesh, (Replicate(),) * mesh.ndim),
                             mu=p_shard, nu=p_shard)
        return p_shard, o_shard, b_shard
    if cell.kind == "prefill":
        return p_shard, b_shard
    s_shard = decode_state_shardings(mesh, rules, cell.cfg,
                                     tree_map(spec_of, cell.args[1]))
    return p_shard, s_shard, b_shard
