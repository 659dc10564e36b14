"""Sharding: a fleet bin's instance axis over a fleet mesh, and the
logical-axis rules of the LM layouts (DP/FSDP/TP/EP/SP over the (pod,
data, model) mesh) as DTensor placements.

Fleet bins (``fleet_sharded``): the instances of a bin are independent,
so a sharded call pads the instance axis to a multiple of the mesh, runs
the wrapped function on each contiguous shard on its mesh device, and
concatenates the outputs on the first device. No collective, no process
group.

LM rules: parameters declare LOGICAL axes (see ``arch/params.py``); a
``Rules`` object maps them to mesh axes, and ``spec_for`` makes the
decisions (a ``PartitionSpec`` per tensor) that ``placements`` turns into
DTensor placements on a ``DeviceMesh``. Activations use a parallel set of
rules applied through the ``shard(x, names)`` hook threaded into the model
(``make_shard_fn``): it redistributes a DTensor and returns a plain tensor,
which is whole on its rank, unchanged.

Divisibility guard: a mapping is dropped (replicated) when the dim size does
not divide the mesh-axis extent. Attention projections avoid the issue
structurally: they are stored fused over (H*hd) — see
arch/layers.attention_specs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..arch.params import PartitionSpec as P, tree_map

Axes = Union[None, str, Tuple[str, ...]]

PAD_OK: set = set()         # logical axes where uneven sharding would be allowed


# ---------------------------------------------------------------------------
# Fleet-bin sharding: partition a megabatch's INSTANCE axis over devices.
# ---------------------------------------------------------------------------

def _tree_map(f, tree):
    """``f`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, v) for v in tree)
    return f(tree)


def _tree_zip(f, trees: list):
    """``f`` on the leaves at one place in each of ``trees`` (one
    structure), into that structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_zip(f, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_zip(f, [t[i] for t in trees])
                        for i in range(len(t0)))
    return f(*trees)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _pad_leading(tree, pad: int):
    """Pad every tensor leaf's leading (instance) axis by repeating its last
    row ``pad`` times. Edge replication — never zeros — so padded instances
    run the same numerics as a real one (e.g. GAM knot rows must stay
    strictly increasing); their outputs are sliced off before anyone reads
    them."""
    def one(a):
        return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
    return _tree_map(one, tree)


def fleet_sharded(fn, mesh, *, replicated_argnums: Tuple[int, ...] = ()):
    """Wrap ``fn`` — independent over every sharded argument's LEADING
    instance axis, collective-free — so that it runs shard by shard over
    the devices of ``mesh`` (a ``launch.mesh.FleetMesh``): shard ``i``,
    rows ``i·N/ndev … (i+1)·N/ndev − 1`` of every sharded argument, on
    ``mesh.devices[i]``.

    The wrapper pads the instance axis up to a multiple of the shard count
    (edge-replicated rows), so uneven bins just work. Arguments listed in
    ``replicated_argnums`` are copied whole to every device. Arguments are
    tensors or nested dicts, lists and tuples of them; the outputs' leaves
    are concatenated on the first device and the pad rows sliced off. The
    shards are issued one after the other from this process: on separate
    cards their kernels overlap, on one card they queue. PyTorch runs
    eagerly, so there is no trace to cache (the reference's ``key``)."""
    devices = tuple(mesh.devices)
    nshard = len(devices)
    repl = frozenset(replicated_argnums)

    def wrapper(*args):
        first = next(a for i, a in enumerate(args) if i not in repl)
        n = _first_leaf(first).shape[0]
        pad = (-n) % nshard
        if pad:
            args = tuple(a if i in repl else _pad_leading(a, pad)
                         for i, a in enumerate(args))
        per = (n + pad) // nshard
        outs = []
        for s, dev in enumerate(devices):
            rows = slice(s * per, (s + 1) * per)
            outs.append(fn(*(
                _tree_map(lambda t: t.to(dev), a) if i in repl
                else _tree_map(lambda t: t[rows].to(dev), a)
                for i, a in enumerate(args))))
        return _tree_zip(
            lambda *xs: torch.cat([x.to(devices[0]) for x in xs])[:n], outs)

    return wrapper


# ---------------------------------------------------------------------------
# LM layouts: logical-axis rules over the (pod, data, model) mesh.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rules:
    params: Dict[str, Axes]
    acts: Dict[str, Axes]
    name: str = "baseline"


def baseline_rules(multi_pod: bool = False) -> Rules:
    dp: Axes = ("pod", "data") if multi_pod else ("data",)
    return Rules(
        name="baseline",
        params={
            "embed": dp,            # FSDP (ZeRO-3): shard d_model dim of weights
            "vocab": ("model",),
            "heads": ("model",),    # TP
            "kv_heads": None,       # few KV heads: replicate (baseline)
            "head": None,
            "mlp": ("model",),      # TP
            "expert": ("model",),   # EP
            "expert_mlp": ("model",),   # collapses onto EP axis (dropped)
            "mamba_proj": ("model",),
            "ssm_inner": ("model",),
            "ssm_heads": ("model",),
            "rwkv_heads": ("model",),
            "rwkv_hidden": ("model",),
            "layers": None,
        },
        acts={
            "batch": dp,
            # MoE dispatch groups shard over dp ONLY so the (B,S,d)->(G,Sg,d)
            # reshape keeps each group's rows on one rank; the expert
            # products' exchange covers the model axis.
            "tokens": dp,
            "expert": ("model",),
            "capacity": ("data",),
            "seq": None,            # "model" under sequence parallelism
            "kv_seq": ("model",),   # decode KV caches: shard S over model
            "kv_heads": None,
            "heads": ("model",),
        })


def serve_rules(multi_pod: bool = False) -> Rules:
    """Weight-STATIONARY serving layout: no FSDP at decode — dense weights
    live TP-sharded (model axis) and are never gathered; MoE expert weights
    are 2D-sharded (expert@model x ffn@data) so a 400B MoE fits without
    per-token weight movement. The KV cache stays (B@data, S@model);
    attention combines S-shards with the distributed flash-decode
    (``kernels/decode_attention/distributed.py``) instead of gathering."""
    base = baseline_rules(multi_pod)
    dp: Axes = ("pod", "data") if multi_pod else ("data",)
    params = dict(base.params)
    params.update({
        "embed": None,               # NO FSDP: weights stationary
        "expert": ("model",),
        "expert_mlp": dp,            # 2D expert sharding
    })
    acts = dict(base.acts)
    return Rules(name="serve_stationary", params=params, acts=acts)


def sp_rules(multi_pod: bool = False) -> Rules:
    """Sequence-parallel training layout: the residual stream (and the remat
    residual stack) shards its SEQUENCE dim over the model axis between
    blocks, so the saved activations shrink by the model extent."""
    base = baseline_rules(multi_pod)
    acts = dict(base.acts)
    acts["seq"] = ("model",)
    return Rules(name="sp", params=dict(base.params), acts=acts)


def _norm(a: Axes) -> Tuple[str, ...]:
    if a is None:
        return ()
    return (a,) if isinstance(a, str) else tuple(a)


def _mesh_extent(mesh, axes: Tuple[str, ...]) -> int:
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.shape[names.index(a)] for a in axes)


def spec_for(mesh, rules: Dict[str, Axes], logical: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> P:
    """PartitionSpec for one tensor given its logical axes + shape. Reads
    only ``mesh.mesh_dim_names`` and ``mesh.shape`` (a ``DeviceMesh``'s,
    or any object with the two)."""
    names = tuple(mesh.mesh_dim_names)
    out, used = [], set()
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in _norm(rules.get(name)) if name is not None
                     and a in names and a not in used)
        if not axes:
            out.append(None)
            continue
        ext = _mesh_extent(mesh, axes)
        if dim % ext != 0 and name not in PAD_OK:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names,
    ``Replicate()`` on the others. A dim split over several axes (a tuple
    in mesh order) takes a ``Shard(d)`` on each, the first outermost, as
    the reference's mesh splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _norm(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def param_shardings(mesh, rules: Rules, spec_tree):
    """ParamSpec tree -> tree of ``(mesh, placements)``."""
    return tree_map(
        lambda s: (mesh, placements(mesh, spec_for(mesh, rules.params,
                                                   s.axes, s.shape))),
        spec_tree)


def make_shard_fn(mesh, rules: Rules):
    """The ``shard(x, logical_names)`` hook threaded through model code: a
    DTensor is redistributed to the activation rule's placements; a plain
    tensor is whole on its rank and comes back unchanged."""
    def shard(x, names):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = spec_for(mesh, rules.acts, names, tuple(x.shape))
        return x.redistribute(mesh, placements(mesh, spec))
    return shard


def batch_shardings(mesh, rules: Rules, batch_specs):
    """Input-batch shardings: leading dim is batch (or dim 1 for (3,B,S))."""
    def one(s):
        if s.shape and s.shape[0] == 3 and len(s.shape) == 3:   # mrope positions
            logical = (None, "batch", None)
        else:
            logical = ("batch",) + (None,) * (len(s.shape) - 1)
        return mesh, placements(mesh, spec_for(mesh, rules.acts, logical,
                                               tuple(s.shape)))
    return tree_map(one, batch_specs)


def _decode_state_logical(leaf: str, nd: int) -> tuple:
    if leaf in ("k", "v"):
        logical = (None, "batch", "kv_seq", "kv_heads", None)
    elif leaf == "ssd":                       # (periods,B,H,P,N)
        logical = (None, "batch", "heads", None, None)
    elif leaf == "wkv":                       # (periods,B,H,K,V)
        logical = (None, "batch", "heads", None, None)
    elif leaf == "conv":                      # (periods,B,w-1,ch)
        logical = (None, "batch", None, None)
    elif leaf in ("x_tm", "x_cm"):            # (periods,B,d)
        logical = (None, "batch", None)
    elif leaf == "lengths":
        logical = ("batch",)
    else:
        logical = (None,) * nd
    return tuple(logical[:nd]) + (None,) * max(0, nd - len(logical))


def decode_state_shardings(mesh, rules: Rules, cfg, state_specs):
    """Decode state tree -> tree of ``(mesh, placements)``, each leaf by its
    name: caches (periods, B, S, KV, hd) -> B on dp, S on model; SSM/RWKV
    states -> B on dp, heads on model."""
    def walk(tree, leaf):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        logical = _decode_state_logical(leaf, len(shape))
        return mesh, placements(mesh, spec_for(mesh, rules.acts, logical,
                                               shape))
    return walk(state_specs, "")


# ---------------------------------------------------------------------------
# DTensors and whole tensors: what the sharded steps move between.
# ---------------------------------------------------------------------------

def local_block(t, mesh, pls):
    """The block of ``t`` (a tensor whole on every rank) that this rank
    holds under placements ``pls`` on ``mesh``: a view, no communication.
    The mesh dims split in order, the first outermost, evenly (the
    divisibility guard keeps every shard even)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n = mesh.shape[i]
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does "
                                 f"not split evenly over {n} ranks")
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[i] * size, size)
    return t


def sharded_extent(mesh, pls) -> int:
    """How many blocks placements ``pls`` cut a tensor into: the product
    of the sizes of the mesh dims it is sharded on."""
    from torch.distributed.tensor import Shard
    return math.prod(n for n, pl in zip(mesh.shape, pls)
                     if isinstance(pl, Shard))


def rows_only(mesh, pls) -> tuple:
    """``pls`` with every mesh dim but the data-parallel ones replicated:
    what a decode step gathers a state leaf to (its batch rows kept)."""
    from torch.distributed.tensor import Replicate
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return tuple(pl if names[i] in dp else Replicate()
                 for i, pl in enumerate(pls))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def place(t, mesh, pls):
    """A tensor whole on every rank as the DTensor of ``pls`` on ``mesh``,
    from this rank's block of it (``local_block``): no communication, no
    copy."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_block(t, mesh, pls), mesh, tuple(pls),
                              run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def place_tree(tree, shardings):
    """A tree (dicts, tuples, NamedTuples) of tensors whole on every rank,
    each placed by ``place`` on its leaf of ``shardings`` (a ``(mesh,
    placements)`` tree of the same structure, as ``param_shardings`` or
    ``launch.cells.cell_shardings`` give)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [place_tree(t, sh) for t, sh in zip(tree, shardings)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return place(tree, *shardings)


def as_local(t, like):
    """``t``, this rank's block under ``like``'s placements, as a DTensor
    of ``like``'s mesh, placements, shape and stride."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def holds_distinct(x, mesh) -> bool:
    """Whether this rank's block of ``x`` counts once in a sum over
    ``mesh``: it sits at coordinate 0 of every mesh dim ``x`` is
    replicated on (a plain tensor, whole on every rank: of every dim)."""
    from torch.distributed.tensor import DTensor, Shard
    pls = x.placements if isinstance(x, DTensor) else ()
    return all(c == 0 or (i < len(pls) and isinstance(pls[i], Shard))
               for i, c in enumerate(mesh.get_coordinate()))


def mesh_sum(t, mesh):
    """Sum ``t`` in place over every rank of ``mesh`` (an all-reduce over
    each mesh dim's group of more than one rank in turn); returns it."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        if mesh.shape[d] > 1:
            dist.all_reduce(t, group=mesh.get_group(d))
    return t


def mesh_mean_autograd(t, mesh):
    """The mean of ``t`` over every rank of ``mesh`` under autograd (its
    gradient is summed back over the ranks)."""
    from torch.distributed.nn.functional import all_reduce
    for d in range(mesh.ndim):
        if mesh.shape[d] > 1:
            t = all_reduce(t, group=mesh.get_group(d))
    return t / mesh.size()


# ---------------------------------------------------------------------------
# Collectives under autograd: what a rank computes on its shards through.
# Each takes an explicit process group of ``n`` ranks; at n = 1 it is the
# identity and issues nothing.
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def all_gather_along(x, dim: int, group, n: int):
    """The blocks of ``group``'s ``n`` ranks concatenated along ``dim`` in
    group-rank order (one all-gather)."""
    dist = _dist()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    ag = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    ag(out, x, group=group)
    return out.unflatten(0, (n, x.shape[0])).movedim(0, dim) \
        .flatten(dim, dim + 1)


def reduce_scatter_along(x, dim: int, group, n: int):
    """The sum over ``group``'s ``n`` ranks of ``x``, each rank keeping its
    block along ``dim`` (one reduce-scatter)."""
    dist = _dist()
    k = x.shape[dim] // n
    parts = x.unflatten(dim, (n, k)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    rs(out, parts.flatten(0, 1), group=group)
    return out


def all_to_all_last(x, send, recv, group):
    """``x``'s last dim cut into pieces of ``send[s]`` for each rank ``s``
    of ``group`` (one all-to-all), the pieces received (``recv[s]`` from
    rank ``s``) concatenated in group-rank order."""
    dist = _dist()
    xt = x.movedim(-1, 0).contiguous()
    out = xt.new_empty((sum(recv),) + tuple(xt.shape[1:]))
    dist.all_to_all_single(out, xt, list(recv), list(send), group=group)
    return out.movedim(0, -1)


def head_slots(heads: int, tp: int, rank: int) -> tuple:
    """(first head, heads) of ``rank``'s slot when ``heads`` are dealt to
    ``tp`` ranks in slots of ceil(heads / tp), in rank order: the last
    slots short or empty where ``tp`` does not divide ``heads``."""
    per = -(-heads // tp)
    lo = min(rank * per, heads)
    return lo, min(per, heads - lo)


def slot_splits(heads: int, unit: int, tp: int) -> tuple:
    """``m[r][s]``: how many of rank ``r``'s block of the columns of a fused
    ``heads`` x ``unit`` projection (``heads * unit / tp`` of them, in rank
    order) fall in rank ``s``'s head slot (``head_slots``)."""
    c = heads * unit // tp
    slots = [head_slots(heads, tp, s) for s in range(tp)]
    return tuple(tuple(max(0, min((r + 1) * c, (lo + n) * unit)
                           - max(r * c, lo * unit)) for lo, n in slots)
                 for r in range(tp))


class _Exchange(torch.autograd.Function):
    """An all-to-all of the last dim (``all_to_all_last``); the backward
    is the inverse exchange: each piece of the gradient goes back to the
    rank it came from."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.args = (recv, send, group)
        return all_to_all_last(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_last(g, *ctx.args), None, None, None


def exchange(x, m, rank: int, group, inverse: bool = False):
    """``x``'s last dim, this rank's block, exchanged over ``group`` by the
    split matrix ``m`` (``m[r][s]`` elements from rank ``r`` to rank
    ``s``; transposed where ``inverse``) under autograd; the identity,
    with no collective, where every rank keeps its own block."""
    if all(v == 0 for r, row in enumerate(m) for s, v in enumerate(row)
           if r != s):
        return x
    send = [m[s][rank] for s in range(len(m))] if inverse else list(m[rank])
    recv = list(m[rank]) if inverse else [m[s][rank] for s in range(len(m))]
    return _Exchange.apply(x, send, recv, group)


def _all_reduce_copy(x, group, op=None):
    dist = _dist()
    x = x.clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _Gather(torch.autograd.Function):
    """All-gather along a dim; the backward reduce-scatters the gradient
    (the sum over the group, this rank's block)."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return all_gather_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_along(g, *ctx.args), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along a dim; the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return reduce_scatter_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather_along(g, *ctx.args), None, None, None


class _CopyIn(torch.autograd.Function):
    """Into a model-parallel region: the identity; the backward sums the
    ranks' partial gradients (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Out of a model-parallel region: the ranks' partial results summed
    (an all-reduce); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_copy(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    """All-gather along a dim into a tensor every rank then uses alike;
    the backward keeps this rank's block of the gradient (each rank holds
    the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.args = (dim, x.shape[dim] * rank, x.shape[dim])
        return all_gather_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.args), None, None, None, None


class _Repeated(torch.autograd.Function):
    """The identity; the backward divides the gradient by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def gather(x, dim: int, group, n: int):
    """All-gather along ``dim`` over ``group`` (``n`` ranks); the gradient
    is reduce-scattered back. FSDP's gather of a weight shard, and
    sequence parallelism's gather of the residual stream."""
    return x if n == 1 else _Gather.apply(x, dim, group, n)


def scatter(x, dim: int, group, n: int):
    """Reduce-scatter along ``dim`` over ``group``; the gradient is
    all-gathered back. Sequence parallelism's way out of a region."""
    return x if n == 1 else _Scatter.apply(x, dim, group, n)


def gather_out(x, dim: int, group, n: int, rank: int):
    """All-gather along ``dim`` over ``group`` (``n`` ranks, this one at
    ``rank``) out of a region whose ranks each computed a block; the
    gradient, whole on every rank, is cut back to this rank's block."""
    return x if n == 1 else _GatherOut.apply(x, dim, group, n, rank)


def copy_in(x, group, n: int):
    """Identity forward, all-reduce backward (tensor parallelism's way
    into a region whose ranks each compute a part)."""
    return x if n == 1 else _CopyIn.apply(x, group)


def reduce_out(x, group, n: int):
    """All-reduce forward, identity backward (the way out of that
    region)."""
    return x if n == 1 else _ReduceOut.apply(x, group)


def sharded_dims(mesh, pls) -> dict:
    """``{mesh dim: tensor dim}`` for each mesh dim of more than one rank
    that placements ``pls`` shard a leaf on (from ``param_shardings``,
    whose ``spec_for`` drops a split that does not divide)."""
    from torch.distributed.tensor import Shard
    return {i: pl.dim for i, pl in enumerate(pls)
            if isinstance(pl, Shard) and mesh.shape[i] > 1}


def gather_dims(x, mesh, dims: dict):
    """``x``, this rank's block, all-gathered over the mesh dims ``dims``
    (``{mesh dim: tensor dim}``), the innermost first: the leaf whole on
    those dims. No autograd."""
    for i in sorted(dims, reverse=True):
        x = all_gather_along(x, dims[i], mesh.get_group(i), mesh.shape[i])
    return x


def cut_dims(x, mesh, dims: dict):
    """This rank's block of ``x`` (whole on the mesh dims ``dims``) on
    those dims: a view, no communication."""
    coord = mesh.get_coordinate()
    for i in sorted(dims):
        n, d = mesh.shape[i], dims[i]
        size = x.shape[d] // n
        x = x.narrow(d, coord[i] * size, size)
    return x


def gather_whole(x):
    """A DTensor gathered whole on every rank (a plain tensor) by an
    all-gather over each mesh dim it is sharded on; a plain tensor is
    taken as whole already."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return gather_dims(x.to_local(), mesh, sharded_dims(mesh, x.placements))


class _Gathered(dict):
    """A parameter tree whose top-level FSDP shards ``TPContext.top``
    gathered."""


@dataclass
class TPContext:
    """What one rank's model code needs to compute on its shards: the
    ``model`` axis's group (``tp`` ranks, this rank at ``rank``), whether
    the residual stream between blocks is this rank's sequence shard
    (``seq``, sequence parallelism), ``fsdp``: for each leaf of the
    parameter tree, the ``(tensor dim, group, ranks)`` all-gathers, the
    innermost mesh dim first, that make its FSDP shard whole over the data
    axes where it is used (the dims of ``"blocks"`` leaves are those of
    one period's slice; ``None`` for a leaf, or subtree, that needs none),
    and ``expert_dp``: the ``(group, ranks)`` of each data-axis mesh dim
    that splits the MoE experts' columns and stays split (the serving
    rules' 2D expert shards), the innermost first.

    The layers read from each weight's shape whether they hold a shard of
    it: a fused head projection narrower than the config's holds this
    rank's block of its columns, which ``to_heads`` exchanges for the
    rank's head slot (its ``H / tp`` heads where ``tp`` divides H, the
    blocks themselves), an MLP projection narrower than ``d_ff`` its
    columns, an embedding shorter than the vocabulary its rows, an expert
    stack shorter than E its experts. Every method is the identity at
    ``tp`` = 1."""
    model: Any = None
    tp: int = 1
    rank: int = 0
    seq: bool = False
    fsdp: Any = None
    expert_dp: tuple = ()

    # FSDP: a period's (or the top-level) leaves gathered where used
    def gather_tree(self, tree, specs):
        if specs is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.gather_tree(v, specs.get(k)) for k, v in
                    tree.items()}
        for dim, group, n in specs:
            tree = gather(tree, dim, group, n)
        return tree

    def period(self, p):
        """One period's parameters, FSDP shards gathered."""
        return self.gather_tree(p, (self.fsdp or {}).get("blocks"))

    def top(self, params):
        """The parameters outside the periods, FSDP shards gathered (once:
        a tree this returned comes back as it is); the stacked periods as
        they are."""
        if isinstance(params, _Gathered):
            return params
        fsdp = self.fsdp or {}
        return _Gathered({k: v if k == "blocks"
                          else self.gather_tree(v, fsdp.get(k))
                          for k, v in params.items()})

    # the residual stream in and out of a block's parts
    def enter(self, x, sharded: bool):
        """``x`` (the residual stream, or its sequence shard under
        ``seq``) as a region computing on weight shards (``sharded``) or
        on whole weights needs it: whole along the sequence."""
        if self.seq:
            return gather(x, 1, self.model, self.tp)
        return copy_in(x, self.model, self.tp) if sharded else x

    def leave(self, y, sharded: bool):
        """A region's output back to the residual stream's layout: the
        ranks' partial sums reduced (``sharded``), this rank's sequence
        shard kept (``seq``)."""
        if sharded:
            return scatter(y, 1, self.model, self.tp) if self.seq \
                else reduce_out(y, self.model, self.tp)
        if self.seq:
            k = y.shape[1] // self.tp
            return y.narrow(1, self.rank * k, k)
        return y

    def repeated(self, x):
        """``x`` (gathered whole along the sequence under ``seq``) as the
        input of a part every rank computes alike: the gather's backward
        sums the ranks' gradients, so each passes a ``tp``-th of its own."""
        if not self.seq or self.tp == 1:
            return x
        return _Repeated.apply(x, self.tp)

    def reduce(self, x):
        """The ranks' partial values summed (forward); the gradient passes
        to each rank unchanged."""
        return reduce_out(x, self.model, self.tp)

    def total(self, x):
        """The ranks' partial values summed, where each rank's own part
        then reads the sum (a norm over channels split over ``model``):
        the gradient of each rank's partial is the sum of the ranks'
        gradients of the total."""
        return copy_in(reduce_out(x, self.model, self.tp), self.model,
                       self.tp)

    def gate(self, r, kv):
        """``r * kv`` in the residual stream's layout, where ``r`` is this
        rank's block of the last dim's columns and ``kv`` the ranks'
        partial sums of every column (RWKV6's channel-mix): ``kv``
        reduce-scattered onto this rank's columns, the product all-gathered
        back (one all-reduce's wire bytes; under ``seq`` this rank's
        sequence shard kept)."""
        dim = kv.ndim - 1
        y = r * scatter(kv, dim, self.model, self.tp)
        if self.seq:
            return self.leave(gather(y, dim, self.model, self.tp), False)
        return gather_out(y, dim, self.model, self.tp, self.rank)

    def max(self, x):
        """The largest value over the ranks (no gradient)."""
        if self.tp == 1:
            return x
        return _all_reduce_copy(x.detach(), self.model,
                                _dist().ReduceOp.MAX)

    def gather_heads(self, x, dim: int):
        """Every rank's heads (or head projection columns) of ``x`` along
        ``dim`` (no gradient)."""
        if self.tp == 1:
            return x
        return all_gather_along(x, dim, self.model, self.tp)

    def to_heads(self, x, heads: int, unit: int):
        """``x``'s last dim, this rank's block of a fused ``heads`` x
        ``unit`` projection's columns, exchanged for this rank's head slot
        of it (``head_slots``): one all-to-all over ``model``, each rank
        sending the columns of its block to the ranks whose slots hold
        them; the backward sends each column's gradient back. The identity
        where ``tp`` divides ``heads`` (the blocks are the slots)."""
        return exchange(x, slot_splits(heads, unit, self.tp), self.rank,
                        self.model)

    def to_cols(self, y, heads: int, unit: int):
        """The inverse of ``to_heads``: ``y``'s last dim, this rank's head
        slot, back to its block of the fused columns."""
        return exchange(y, slot_splits(heads, unit, self.tp), self.rank,
                        self.model, inverse=True)
