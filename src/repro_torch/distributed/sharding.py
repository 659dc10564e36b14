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
from typing import Dict, Optional, Tuple, Union

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
