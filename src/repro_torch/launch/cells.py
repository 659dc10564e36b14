"""Build one cell: (arch x input shape x mesh) -> the step under its
shardings + meta-device args. Shared by the dry run (``launch/dryrun.py``)
and the sharded training and serving runs.

The twin of ``repro.launch.cells``, whose ``jax.jit(step, in_shardings=,
out_shardings=)`` lets XLA partition the model over the mesh. Here a
cell's ``fn`` takes DTensors at the rules' placements and each rank
computes on its own shards, as XLA partitions the reference's cell:

  * tensor parallelism over ``model``: an ``attn`` block's fused q
    columns and ``wo`` rows, the MLP's columns and ``w_down`` rows, the
    embedding's, LM head's and cross-entropy's vocabulary
    (``arch/layers.py``, ``arch/model.py``); two all-reduces a block
    forward (the attention's and the MLP's partial sums) and two backward,
    and three a loss chunk. A rank attends on its head slot: its ``H /
    tp`` heads where the model extent divides H; else, where a rank's
    ``H hd / tp`` columns cut a head (starcoder2-7b's H 36, qwen2-vl-7b's
    28 and llama4-maverick's 40 on 16 ranks), ``ceil(H / tp)`` heads (the
    last slots short or empty), q exchanged from the column blocks onto
    the slots and the output back by two all-to-alls a block forward and
    two backward (``TPContext.to_heads``, ``to_cols``); a decode step with
    ``dist_decode`` gathers the columns instead (below);
  * expert parallelism over ``model`` (``arch/moe.py``): an ``attn_moe``
    block's experts, ``E / tp`` a rank (or, where E does not divide the
    extent, every expert's ``d_ff / tp`` columns), the shared expert's
    columns as the MLP's; the ranks route their shared rows alike and
    each combines its experts' choices, one f32 all-reduce a block
    forward (and the shared expert's), the input's and the gates' sums
    backward; no all-to-all. The router (d x E) is gathered over
    ``model`` once a call;
  * Mamba2 over ``model`` (``arch/mamba2.py``): a mixer's SSD heads, ``H
    / tp`` a rank (``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and
    ``out_proj``'s rows on their heads' shards). Its fused ``in_proj``
    splits uniformly, its shards straddling ``[z, x, B, C, dt]``: in
    train and prefill cells the weight moves (gathered over ``model`` with
    its period, each rank multiplying by its heads' columns and the whole
    B and C, the gradient reduce-scattered back); in decode cells the
    activation moves (each rank multiplies by its column shard and
    all-gathers the product over ``model``). ``conv_w`` and ``conv_b`` are
    gathered over ``model`` once a call. The gated RMSNorm's sum of
    squares is an all-reduce a block forward and one backward, beside the
    out-projection's partial sums. The ``ssd`` decode state keeps its
    heads on ``model``; the ``conv`` state is whole on every rank.
    Zamba2's shared block computes on its heads and MLP columns as an
    ``attn`` block's, its FSDP shards gathered once a call;
  * RWKV6 over ``model`` (``arch/rwkv6.py``): a time-mix's WKV heads, ``H
    / tp`` a rank (``wr``, ``wk``, ``wv``, ``wg`` column shards, ``u``'s
    rows, ``wo``'s row shard), the lerp and the decay's low-rank input
    computed at full width on every rank and ``w0``, ``w_lora_B`` and the
    group norm whole, used at the rank's channels; ``wo``'s partial sums
    an all-reduce a block forward, the copy-in's backward. A
    channel-mix's ``wk`` columns and ``wv`` rows, and the receptance
    ``wr``'s d columns: the partial ``kv`` reduce-scattered onto the
    rank's columns, gated, and the product all-gathered (the wire of one
    all-reduce; backward, the reduce-scatter's all-gather and the
    copy-in's all-reduce). The ``wkv`` decode state keeps its heads on
    ``model``; ``x_tm`` and ``x_cm`` are whole on every rank;
  * FSDP over the data axes: a period's ``embed``-sharded leaves are
    all-gathered just before the period and again in its remat
    recompute, and their gradients reduce-scattered back to the shard;
  * sequence parallelism (``sp_rules``): the residual stream between
    blocks is this rank's sequence shard, the all-reduces becoming an
    all-gather in and a reduce-scatter out;
  * serving (``serve_rules``: no FSDP): the weights never move; a decode
    step with ``dist_decode`` keeps the KV cache (B@data, S@model), gathers
    every rank's q columns (B x H x hd a token), attends over its sequence
    shard and combines (``kernels/decode_attention/distributed.py``), and
    keeps its own columns of the output for its row shard of ``wo``; the
    experts
    stay 2D (``expert@model`` x ``expert_mlp@data``): each MoE block
    all-gathers its expert buffer's token groups over the data axes and
    reduce-scatters its partial products back.

The plan of each leaf (``leaf_plans``) says where it is gathered and how
its gradient is reduced. Where a part's shards would not be whole heads
of its kind, its leaves are gathered over ``model`` once a call and it
computes replicated, the *guard*: a Mamba2 mixer whose SSD heads do not
divide the model extent, an RWKV6 time-mix whose rank's d / tp columns
are not whole heads and a channel-mix whose d or d_ff does not divide it.
An attention block never takes it: its fused projections split wherever
H x hd divides the extent (else the rules leave them whole). A cell
records which parts took the guard (``Cell.guarded``: ``"pos{j}.mixer"``,
``"pos{j}.tm"``, ``"pos{j}.cm"``), which MoE blocks compute on expert
shards (``Cell.expert_split``), which Mamba2 blocks on their heads
(``Cell.mamba_split``) and how their ``in_proj`` columns reach the rank
(``Cell.in_proj_route``), and which RWKV6 parts on their shards
(``Cell.rwkv_split``).

A training step's microbatch rows are spread over the data-parallel
ranks (gcd(dp ranks, rows) slices, consecutive ranks sharing a slice);
the model axis's ranks share their rows. The gradients are reduced: over
the data axes by the FSDP reduce-scatters, or an all-reduce for leaves
replicated there, then divided by the data-parallel extent; over
``model`` by a sum only for leaves replicated there that each rank used
in part (the KV projections and the per-head norms of a split attention,
whose ranks read their slots' KV heads, a split mixer's
``conv_w`` and ``conv_b``, a split RWKV6 part's ``RWKV_PARTIAL``, and
under sequence parallelism every such leaf but the MoE routers, whose
gradient is whole on every rank). ``grad_hook`` then runs on the whole
gradients (where the reference's runs), the clip's global norm is taken
over the distinct shards (a shard replicated on a mesh dim counts once),
and AdamW runs on each rank's shards; the moments shard like the
parameters and the step count is replicated. MoE token groups stay the
reference's (``moe_groups`` = the mesh size over the global batch): a
rank runs its rows' share of them, and the router's load-balance means
are taken over every rank's tokens (the ``token_mean`` it passes to the
routers). The result equals the unsharded step's on the global batch, up
to the order of the sums.

Prefill and decode keep the batch placement's rows (``batch_shardings``:
the data-parallel axes). Their logits leave the cell as DTensors sharded
over the vocabulary where the head is.

``lower_cell`` has no twin: nothing is lowered to XLA here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..arch import model as M
from ..arch.layers import kv_range
from ..arch.mamba2 import _dims as mamba_dims
from ..arch.moe import dispatch_geometry
from ..arch.params import shape_structs, tree_leaves
from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..data.synthetic import input_specs_for
from ..distributed.checkpoint import tree_map
from ..distributed.sharding import (Rules, TPContext, as_local,
                                    baseline_rules, batch_shardings,
                                    contiguous_stride, cut_dims,
                                    decode_state_shardings, gather_dims,
                                    gather_whole, holds_distinct,
                                    local_block, make_shard_fn,
                                    mesh_mean_autograd, mesh_sum,
                                    param_shardings, sharded_dims,
                                    sharded_extent, spec_for)
from ..launch.mesh import MeshShape, dp_axes
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
    grad_hook: bool = False
    guarded: Tuple[str, ...] = field(default_factory=tuple)
    expert_split: Tuple[str, ...] = field(default_factory=tuple)
    mamba_split: Tuple[str, ...] = field(default_factory=tuple)
    rwkv_split: Tuple[str, ...] = field(default_factory=tuple)
    in_proj_route: str = ""
    kv_chunks: bool = False


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
    """How many slices ``rows`` rows are cut into over ``mesh``'s ranks:
    gcd(ranks, rows); ``mesh.size() // split`` consecutive ranks share a
    slice. A training microbatch is cut so over the axes its rows spread
    over (``row_mesh``)."""
    return math.gcd(mesh.size(), rows)


def row_mesh(mesh) -> MeshShape:
    """The mesh axes a cell's rows spread over, the data-parallel ones (the
    model axis's ranks share their rows), as a mesh (names and sizes)."""
    names = tuple(mesh.mesh_dim_names)
    axes = dp_axes(mesh)
    return MeshShape(tuple(mesh.shape[names.index(a)] for a in axes), axes)


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


def _batch_dim(key: str) -> int:
    return 1 if key == "positions" else 0         # M-RoPE (3, B, S)


# ------------------------------------------------------------ leaf plans

#: the parts of a block, and the top-level leaves, that the TP code
#: computes on their shards; every other leaf sharded on ``model`` keeps
#: the gather-whole path
TP_PARTS = ("ln1", "ln2", "attn", "mlp", "moe", "mixer", "tm", "cm")
TP_TOP = ("embed", "lm_head", "final_norm", "ln0", "shared")
#: a TP attention's leaves replicated on ``model`` that each rank uses in
#: part (its KV heads, and the per-head norms on its q heads)
PARTIAL = ("wk", "wv", "bk", "bv", "q_norm", "k_norm")
#: a Mamba2 mixer's leaves each rank uses in part where they are whole
#: on it (its heads' columns and conv channels, and the shared B and C)
MIXER_PARTIAL = ("in_proj", "conv_w", "conv_b")
#: a mixer's leaves gathered over ``model`` once a call
MIXER_UPFRONT = ("conv_w", "conv_b")
#: an RWKV6 block's leaves whole on ``model`` that a rank uses where its
#: time-mix or channel-mix splits: the time-mix's lerp (``mu_x``, ``mu_5``,
#: ``lora_A``, ``lora_B``) and decay (``w_lora_A``), whose outputs feed
#: the split projections, its heads' channels of ``w0``, ``w_lora_B`` and
#: the group norm's ``ln_x_*``; the channel-mix's ``mu_k`` and ``mu_r``
RWKV_PARTIAL = ("mu_x", "mu_5", "lora_A", "lora_B", "w0", "w_lora_A",
                "w_lora_B", "ln_x_scale", "ln_x_bias", "mu_k", "mu_r")


@dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf is computed on and reduced in a cell:
    ``upfront`` ({mesh dim: tensor dim}) is gathered once a call, ``fsdp``
    (data-parallel mesh dims, and ``model`` for a split mixer's
    ``in_proj`` outside decode cells) where the leaf is used (a period's
    just before it, again in its recompute, the gradient reduce-scattered
    back); ``stationary`` (data-parallel mesh dims) is never gathered: the
    MoE experts' columns under the serving rules, whose ranks gather the
    rows instead (its gradient, taken over every rank's rows, is not
    reduced over them); ``model_sum``: its gradient is summed over
    ``model``."""
    path: Tuple[str, ...]
    placements: tuple
    upfront: Dict[int, int]
    fsdp: Dict[int, int]
    model_sum: bool
    stationary: Dict[int, int] = field(default_factory=dict)


def _paths(tree, pre=()):
    """(path, leaf) of a dict tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], pre + (k,))]
    return [(pre, tree)]


def model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def seq_parallel(mesh, rules: Rules, seq_len: int) -> bool:
    """Whether the residual stream is sequence-sharded over ``model``
    (the rules' ``seq`` activation axis, where S divides)."""
    m = model_dim(mesh)
    return m is not None and mesh.shape[m] > 1 and "model" in _axes(
        spec_for(mesh, rules.acts, ("seq",), (seq_len,))[0])


def _axes(entry) -> tuple:
    """A ``PartitionSpec`` entry's mesh axes."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _heads_split(cfg, mesh, rules) -> bool:
    """Whether the attention's head projection is sharded on ``model``."""
    m = model_dim(mesh)
    if m is None or mesh.shape[m] == 1 or not cfg.num_heads:
        return False
    spec = spec_for(mesh, rules.params, ("embed", "heads"),
                    (cfg.d_model, cfg.num_heads * cfg.head_dim))
    return "model" in _axes(spec[1])


def _on_model(rules: Rules, name: str) -> bool:
    """Whether the rules map logical axis ``name`` to ``model``."""
    return "model" in _axes(rules.params.get(name))


def guarded_positions(cfg: ModelConfig, mesh, rules: Rules) -> tuple:
    """The parts the rules would split over ``model`` where a rank's shard
    is not whole heads of its kind, which are gathered there and computed
    replicated: the Mamba2 mixers (``"pos{j}.mixer"``) whose SSD heads do
    not divide the model extent, and the RWKV6 time-mixes (``"pos{j}.tm"``)
    and channel-mixes (``"pos{j}.cm"``) some of whose leaves the rules
    split where the part cannot split whole (``_rwkv_parts``). Attention
    blocks are never listed: a split that cuts heads computes on head
    slots (``arch/layers.head_range``)."""
    m = model_dim(mesh)
    if m is None or mesh.shape[m] == 1:
        return ()
    n, out = mesh.shape[m], []
    if _on_model(rules, "ssm_heads") and cfg.ssm_heads % n:
        out += [f"pos{j}.mixer" for j, kind in enumerate(cfg.pattern)
                if kind == "mamba2"]
    split, touched = _rwkv_parts(cfg, n, rules)
    out += [f"pos{j}.{part}" for j, kind in enumerate(cfg.pattern)
            if kind == "rwkv6" for part in ("tm", "cm")
            if part in touched and part not in split]
    return tuple(out)


def _rwkv_parts(cfg: ModelConfig, n: int, rules: Rules) -> tuple:
    """(the RWKV6 parts that split over a model axis of ``n`` ranks, those
    the rules split any leaf of): the time-mix (``"tm"``) on whole WKV heads
    where ``rwkv_heads`` and ``rwkv_hidden`` split and each rank's d / n
    columns are whole heads; the channel-mix (``"cm"``) where ``mlp`` and
    ``rwkv_hidden`` split and d_ff and d divide ``n``."""
    if "rwkv6" not in cfg.pattern or n == 1:
        return (), ()
    d, ff, H = cfg.d_model, cfg.d_ff, cfg.rwkv_heads
    K = cfg.rwkv_head_size
    hidden = _on_model(rules, "rwkv_hidden") and d % n == 0
    heads = _on_model(rules, "rwkv_heads") and H % n == 0
    mlp = _on_model(rules, "mlp") and ff % n == 0
    split = (("tm",) if hidden and heads and (d // n) % K == 0 else ()) \
        + (("cm",) if hidden and mlp else ())
    touched = (("tm",) if hidden or heads else ()) \
        + (("cm",) if hidden or mlp else ())
    return split, touched


def mamba_split_positions(cfg: ModelConfig, mesh, rules: Rules) -> tuple:
    """The pattern positions (``"pos{j}"``) of Mamba2 blocks whose mixer
    computes on its SSD heads' shards over ``model``."""
    m = model_dim(mesh)
    if m is None or mesh.shape[m] == 1 \
            or not _on_model(rules, "ssm_heads") \
            or cfg.ssm_heads % mesh.shape[m]:
        return ()
    return tuple(f"pos{j}" for j, kind in enumerate(cfg.pattern)
                 if kind == "mamba2")


def rwkv_split_positions(cfg: ModelConfig, mesh, rules: Rules) -> tuple:
    """The RWKV6 parts that compute on their ``model``-axis shards: a
    time-mix on its WKV heads (``"pos{j}.tm"``), a channel-mix on its
    columns (``"pos{j}.cm"``)."""
    m = model_dim(mesh)
    if m is None:
        return ()
    split = _rwkv_parts(cfg, mesh.shape[m], rules)[0]
    return tuple(f"pos{j}.{part}" for j, kind in enumerate(cfg.pattern)
                 if kind == "rwkv6" for part in ("tm", "cm")
                 if part in split)


def in_proj_route(cfg: ModelConfig, mesh, rules: Rules, kind: str) -> str:
    """How the split mixers reach their ``in_proj`` columns in a ``kind``
    cell: ``"weight"`` (train, prefill: the column shards gathered over
    ``model`` with their period, each rank multiplying by its heads'
    columns and B, C), ``"activation"`` (decode: each rank multiplies by
    its column shard and gathers the product over ``model``),
    ``"whole"`` (the rules leave ``in_proj`` whole on ``model``), or
    ``""`` where no mixer splits."""
    if not mamba_split_positions(cfg, mesh, rules):
        return ""
    spec = spec_for(mesh, rules.params, ("embed", "mamba_proj"),
                    (cfg.d_model, mamba_dims(cfg)[4]))
    if "model" not in _axes(spec[1]):
        return "whole"
    return "activation" if kind == "decode" else "weight"


def kv_cache_chunks(cfg: ModelConfig, mesh, rules: Rules, kind: str,
                    seq_len: int) -> bool:
    """Whether a ``kind`` cell's attention writes its k/v caches at this
    rank's sequence chunk (``layers.attention_block``'s ``cache="chunks"``;
    the caches' layout over ``model``) rather than every position: a
    prefill whose attention splits on whole heads and whose sequence
    splits over ``model``, where each rank's k/v of the KV heads its q
    heads read (the most over the ranks) over the whole sequence and of
    every KV head over its chunk cost less than every KV head over the
    whole sequence (never on a model extent of 2)."""
    m = model_dim(mesh)
    if kind != "prefill" or m is None \
            or not _heads_split(cfg, mesh, rules):
        return False
    n, KV = mesh.shape[m], cfg.num_kv_heads
    if cfg.num_heads % n or seq_len % n:
        return False
    hq = cfg.num_heads // n
    most = max(b - a for a, b in (kv_range(cfg, r * hq, hq)
                                  for r in range(n)))
    return most * n + KV < KV * n


def expert_split_positions(cfg: ModelConfig, mesh, rules: Rules) -> tuple:
    """The pattern positions (``"pos{j}"``) of MoE blocks whose experts
    the rules split (over ``model`` by experts or columns, or over the
    data axes by columns), which compute on their expert shards."""
    if not cfg.num_experts:
        return ()
    spec = spec_for(mesh, rules.params, ("expert", "embed", "expert_mlp"),
                    (cfg.num_experts, cfg.d_model, cfg.d_ff))
    axes = _axes(spec[0]) + _axes(spec[2])
    if not any(n > 1 for a, n in zip(mesh.mesh_dim_names, mesh.shape)
               if a in axes):
        return ()
    return tuple(f"pos{j}" for j, kind in enumerate(cfg.pattern)
                 if kind == "attn_moe")


def leaf_plans(cfg: ModelConfig, mesh, rules: Rules, *,
               seq: bool = False, decode: bool = False) -> list:
    """Every parameter leaf's ``LeafPlan``, in ``tree_leaves`` order, on
    ``mesh`` (a ``DeviceMesh`` or ``MeshShape``) under ``rules``; a leaf
    outside ``TP_PARTS`` and ``TP_TOP`` gathered whole once a call. ``decode``: the
    plans of a decode cell (a split mixer's ``in_proj`` stays a column
    shard on ``model``; elsewhere it is gathered there with its period)."""
    specs = M.build_param_specs(cfg)
    shardings = param_shardings(mesh, rules, specs)
    m = model_dim(mesh)
    dp = {i for i, a in enumerate(mesh.mesh_dim_names) if a in ("pod",
                                                                 "data")}
    mamba = set(mamba_split_positions(cfg, mesh, rules))
    rwkv = set(rwkv_split_positions(cfg, mesh, rules))
    heads = _heads_split(cfg, mesh, rules)
    out = []
    for (path, spec), (_, (_, pls)) in zip(_paths(specs), _paths(shardings)):
        dims = sharded_dims(mesh, pls)
        block = path[0] == "blocks"
        tp_leaf = path[2] in TP_PARTS if block else path[0] in TP_TOP
        # a block's position (or the top-level key) and its part
        where = path[1] if block else path[0]
        part = path[2] if block else (path[1] if len(path) > 2 else None)
        router = block and path[2:] == ("moe", "router")
        mixer = block and part == "mixer"
        split_mixer = mixer and where in mamba
        rwkv_part = block and part in ("tm", "cm")
        split_rwkv = rwkv_part and f"{where}.{part}" in rwkv
        if not tp_leaf:                       # gather-whole, once a call
            upfront = dict(dims)
        elif router or (mixer and not split_mixer) \
                or (split_mixer and path[-1] in MIXER_UPFRONT) \
                or (rwkv_part and not split_rwkv):
            upfront = {i: d for i, d in dims.items() if i == m}
        else:
            upfront = {}
        # the experts' columns over the data axes (2D expert shards)
        stationary = {i: d for i, d in dims.items() if tp_leaf and i in dp
                      and spec.axes[d] == "expert_mlp"}
        fsdp = {i: d for i, d in dims.items() if i in dp
                and i not in upfront and i not in stationary}
        if split_mixer and path[-1] == "in_proj" and m in dims \
                and not decode:
            fsdp[m] = dims[m]            # the weight moves with its period
        replicated = m is None or m not in dims or m in upfront
        # every rank's router gradient is whole (``arch/moe.py``)
        partial = not router and (seq or (
            tp_leaf and part == "attn" and path[-1] in PARTIAL and heads)
            or (split_mixer and path[-1] in MIXER_PARTIAL)
            or (split_rwkv and path[-1] in RWKV_PARTIAL))
        out.append(LeafPlan(path, tuple(pls), upfront, fsdp,
                            bool(replicated and partial and m is not None
                                 and mesh.shape[m] > 1), stationary))
    return out


def tp_context(mesh, plans: list, seq: bool) -> TPContext:
    """This rank's ``TPContext`` on ``mesh`` (a ``DeviceMesh``): the model
    axis's group and coordinate, and each leaf's FSDP gathers (the
    innermost mesh dim first; a period's dims one less than its stacked
    leaf's)."""
    m = model_dim(mesh)
    n = mesh.shape[m] if m is not None else 1
    fsdp: dict = {}
    expert_dp = ()
    for plan in plans:
        if plan.stationary and plan.path[-1] == "w_gate":
            expert_dp = tuple((mesh.get_group(i), mesh.shape[i])
                              for i in sorted(plan.stationary, reverse=True))
        if not plan.fsdp:
            continue
        off = 1 if plan.path[0] == "blocks" else 0
        node = fsdp
        for k in plan.path[:-1]:
            node = node.setdefault(k, {})
        node[plan.path[-1]] = tuple(
            (plan.fsdp[i] - off, mesh.get_group(i), mesh.shape[i])
            for i in sorted(plan.fsdp, reverse=True))
    return TPContext(model=mesh.get_group(m) if n > 1 else None, tp=n,
                     rank=mesh.get_coordinate()[m] if m is not None else 0,
                     seq=seq, fsdp=fsdp, expert_dp=expert_dp)


def _compute_params(params, plans, mesh):
    """This rank's leaves as the model computes on them: each block
    (``to_local``), its ``upfront`` dims gathered."""
    leaves = [gather_dims(p.to_local().detach(), mesh, plan.upfront)
              for p, plan in zip(tree_leaves(params), plans)]
    return _unflatten(params, leaves)


def row_dims(mesh) -> list:
    """The mesh dims of more than one rank that a cell's rows spread over
    (``row_mesh``)."""
    axes = dp_axes(mesh)
    return [i for i, a in enumerate(mesh.mesh_dim_names)
            if a in axes and mesh.shape[i] > 1]


def _row_coord(mesh) -> tuple:
    """(flat coordinate over ``row_mesh``'s axes, their extent)."""
    flat, ext = 0, 1
    coord = mesh.get_coordinate()
    axes = dp_axes(mesh)
    for i, a in enumerate(mesh.mesh_dim_names):
        if a in axes:
            flat, ext = flat * mesh.shape[i] + coord[i], ext * mesh.shape[i]
    return flat, ext


def _at_rows(x, mesh, bdim: int) -> bool:
    """Whether DTensor ``x`` holds its rows (dim ``bdim``) split over every
    data-parallel mesh dim and nothing else: its local block is this
    rank's rows where they spread over the data axes."""
    return sharded_dims(mesh, x.placements) == {
        i: bdim for i, a in enumerate(mesh.mesh_dim_names)
        if a in ("pod", "data") and mesh.shape[i] > 1}


def _micro_rows(batch, mesh, microbatches: int):
    """This rank's rows of each microbatch: slice ``k`` of
    ``train_split(row_mesh, rows)`` of microbatch ``i`` (rows ``i rows + k
    per``), from its block where the rows spread over the data axes, the
    batch is split over them alone and one microbatch is cut as the
    batch, else from the batch gathered whole. Returns (microbatches,
    rows, split)."""
    from torch.distributed.tensor import DTensor
    B = batch["labels"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         "microbatches")
    rows = B // microbatches
    flat, ext = _row_coord(mesh)
    split = train_split(row_mesh(mesh), rows)
    per = rows // split
    k = flat // (ext // split)
    local = microbatches == 1 and split == ext
    micro = [{} for _ in range(microbatches)]
    for key, x in sorted(batch.items()):
        bdim = _batch_dim(key)
        if isinstance(x, DTensor) and local and _at_rows(x, mesh, bdim):
            micro[0][key] = x.to_local()
            continue
        x = gather_whole(x)
        for i in range(microbatches):
            micro[i][key] = x.narrow(bdim, i * rows + k * per, per)
    return micro, rows, split


def make_sharded_grad_fn(cfg: ModelConfig, mesh, rules: Rules, *,
                         remat: bool = True, moe_path: str = "dispatch",
                         microbatches: int = 1,
                         grad_hook: Optional[Callable] = None,
                         scan_unroll=1, moe_groups: int = 0,
                         cast_params_bf16: bool = False):
    """Returns grads(params, batch) -> (this rank's blocks of the step's
    gradients, in ``tree_leaves`` order and at the params' placements,
    metrics with the clip's ``grad_norm``): the train step's gradients
    before the update (``make_sharded_train_step``'s arguments and
    layout). Every rank of the mesh calls it."""
    import torch.distributed as dist
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    shard = make_shard_fn(mesh, rules)
    f32 = torch.float32
    # the router's means over every rank's tokens
    token_mean = (lambda m: mesh_mean_autograd(m, mesh)) \
        if _is_moe(cfg) else None

    def grads_of(params, batch):
        micro, rows, split = _micro_rows(batch, mesh, microbatches)
        S = micro[0]["labels"].shape[1]
        for mb in micro:              # each rank holds the same token count
            assert mb["labels"].shape == (rows // split, S), \
                mb["labels"].shape
        seq = seq_parallel(mesh, rules, S)
        plans = leaf_plans(cfg, mesh, rules, seq=seq)
        grad_fn = make_grad_fn(
            cfg, shard=shard, remat=remat, moe_path=moe_path,
            scan_unroll=scan_unroll,
            moe_groups=local_moe_groups(cfg, rows * S, moe_groups, split),
            cast_params_bf16=cast_params_bf16, token_mean=token_mean,
            tp=tp_context(mesh, plans, seq))
        grads, metrics = grad_fn(_compute_params(params, plans, mesh), micro)
        # the mean over the row slices, in place: the FSDP reduce-scatters
        # summed a leaf over its shard's dims; the other row dims, and the
        # model axis where a leaf's ranks each hold a part, are summed here
        rdims, m = row_dims(mesh), model_dim(mesh)
        ext = _row_coord(mesh)[1]
        g_local = []
        for g, plan in zip(grads, plans):
            for i in rdims:
                if i not in plan.fsdp and i not in plan.stationary:
                    dist.all_reduce(g, group=mesh.get_group(i))
            if plan.model_sum:
                dist.all_reduce(g, group=mesh.get_group(m))
            g_local.append(cut_dims(g.div_(ext), mesh, plan.upfront))
        del grads
        for key, v in metrics.items():
            v = v.clone()
            for i in rdims:
                dist.all_reduce(v, group=mesh.get_group(i))
            metrics[key] = v / ext
        p_leaves = tree_leaves(params)
        if grad_hook is not None:     # on the whole gradients
            dims = [sharded_dims(mesh, p.placements) for p in p_leaves]
            hooked = grad_hook(_unflatten(params, [
                gather_dims(g, mesh, d) for g, d in zip(g_local, dims)]))
            g_local = [cut_dims(g, mesh, d)
                       for g, d in zip(tree_leaves(hooked), dims)]
        # the clip's global norm: each distinct shard once, then the sum
        # over the mesh
        sq = sum(torch.sum(torch.square(g.to(f32)))
                 if holds_distinct(p, mesh) else torch.zeros((), dtype=f32,
                                                             device=g.device)
                 for g, p in zip(g_local, p_leaves))
        metrics["grad_norm"] = torch.sqrt(mesh_sum(sq, mesh))
        return g_local, metrics

    return grads_of


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
    Every rank of the mesh calls it (see the module's docstring): the
    gradients of ``make_sharded_grad_fn``, then AdamW on each rank's
    shards."""
    grads_of = make_sharded_grad_fn(
        cfg, mesh, rules, remat=remat, moe_path=moe_path,
        microbatches=microbatches, grad_hook=grad_hook,
        scan_unroll=scan_unroll, moe_groups=moe_groups,
        cast_params_bf16=cast_params_bf16)

    def step(params, opt_state, batch):
        g_local, metrics = grads_of(params, batch)
        gnorm = metrics.pop("grad_norm")
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


def _to(x, mesh, pls):
    """This rank's block of ``x`` at placements ``pls``: a DTensor there
    already gives its local block, any other its whole (gathered by
    ``gather_whole``) cut."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and tuple(x.placements) == tuple(pls):
        return x.to_local()
    return local_block(gather_whole(x), mesh, pls)


def _local_batch(mesh, rules: Rules, batch):
    """This rank's rows of each batch leaf (at ``batch_shardings``) and
    the placements of the tokens' rows."""
    specs = {k: M.TensorSpec(tuple(x.shape), x.dtype)
             for k, x in batch.items()}
    shardings = batch_shardings(mesh, rules, specs)
    out = {key: _to(x, mesh, shardings[key][1]) for key, x in batch.items()}
    return out, shardings["tokens" if "tokens" in batch else "frames"][1]


def _serve_setup(cfg, mesh, rules, params, seq_len: int,
                 decode: bool = False):
    """(compute params, TPContext or None) of a serve cell's call."""
    seq = seq_parallel(mesh, rules, seq_len)
    plans = leaf_plans(cfg, mesh, rules, seq=seq, decode=decode)
    return _compute_params(params, plans, mesh), \
        tp_context(mesh, plans, seq)


def _logits_out(cfg, mesh, logits, row_pls, B: int):
    """The cell's logits (this rank's rows, and its vocab columns where
    the head is sharded) as a DTensor of global shape (B, V)."""
    from torch.distributed.tensor import DTensor, Shard
    pls = list(_rows_placements(mesh, row_pls, 0))
    m = model_dim(mesh)
    if logits.shape[-1] < cfg.vocab_size:
        pls[m] = Shard(1)
    shape = (B, cfg.vocab_size)
    return DTensor.from_local(logits, mesh, tuple(pls), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def make_sharded_prefill_step(cfg: ModelConfig, mesh, rules: Rules, *,
                              moe_path: str = "dispatch",
                              moe_groups: int = 0):
    """Returns prefill(params, batch) -> (logits, decode state) on
    ``mesh``: this rank's rows of the batch (at ``batch_shardings``) on its
    parameter shards; the caches DTensors with their rows where the
    batch's are (whole on ``model``, but for the k/v caches of attention
    split over heads, which hold this rank's sequence chunk, and the
    ``ssd`` states of mixers and the ``wkv`` states of time-mixes split
    over ``model``, which hold its heads: as ``decode_state_shardings``
    places them; ``kv_cache_chunks``), the last-token logits with their
    rows there and their vocabulary over ``model`` where the head is
    sharded."""
    from torch.distributed.tensor import DTensor, Shard
    shard = make_shard_fn(mesh, rules)
    heads = _state_heads(cfg, mesh, rules)

    def prefill(params, batch):
        local, row_pls = _local_batch(mesh, rules, batch)
        split = sharded_extent(mesh, row_pls)
        B, S = batch["tokens" if "tokens" in batch else "frames"].shape[:2]
        groups = local_moe_groups(cfg, B * S, moe_groups, split)
        compute, tp = _serve_setup(cfg, mesh, rules, params, S)
        chunks = kv_cache_chunks(cfg, mesh, rules, "prefill", S)
        logits, state = make_prefill_step(
            cfg, shard=shard, moe_path=moe_path, moe_groups=groups,
            tp=tp, cache="chunks" if chunks else True)(compute, local)

        def out(name, t, dim):
            pls = list(_rows_placements(mesh, row_pls, dim))
            shape = list(t.shape)
            shape[dim] *= split
            if name in heads:       # (periods, B, H, ...): its heads
                pls[model_dim(mesh)] = Shard(2)
                shape[2] = heads[name]
            elif chunks and name in ("k", "v"):
                # (periods, B, S, KV, hd): this rank's sequence chunk
                pls[model_dim(mesh)] = Shard(2)
                shape[2] = S
            return DTensor.from_local(t, mesh, tuple(pls), run_check=False,
                                      shape=torch.Size(shape),
                                      stride=contiguous_stride(shape))
        state = {"caches": _walk(lambda n, t: out(n, t, 1),
                                 state["caches"]),
                 "lengths": out("lengths", state["lengths"], 0)}
        return _logits_out(cfg, mesh, logits, row_pls, B), state

    return prefill


def make_sharded_decode_step(cfg: ModelConfig, mesh, rules: Rules, *,
                             moe_path: str = "dispatch", scan_unroll=1,
                             moe_groups: int = 0, dist_decode: bool = False):
    """Returns decode(params, state, batch) -> (logits, state) on
    ``mesh``, on this rank's parameter shards: the state's leaves DTensors
    at ``decode_state_shardings`` (or plain, whole on every rank), each
    gathered to this rank's rows over every non-data-parallel mesh dim,
    except, with ``dist_decode``, the k/v caches, which stay sequence
    shards and attend through the distributed flash-decode, and the
    ``ssd`` and ``wkv`` states of mixers split over ``model``, which stay
    this rank's heads; the new state
    at the state's placements (its k/v chunks written in place, as the
    reference donates the state); the logits as ``prefill``'s."""
    from torch.distributed.tensor import DTensor
    shard = make_shard_fn(mesh, rules)
    attn_dist = {"mesh": mesh, "seq_axis": "model",
                 "batch_axes": dp_axes(mesh)} if dist_decode else None
    heads = _state_heads(cfg, mesh, rules)

    def local(path) -> bool:
        """Whether a state leaf stays as this rank holds it."""
        return (dist_decode and path in ("k", "v")) or path in heads

    def decode(params, state, batch):
        local_b, row_pls = _local_batch(mesh, rules, batch)
        split = sharded_extent(mesh, row_pls)
        B = batch["tokens"].shape[0]
        specs = tree_map(lambda x: M.TensorSpec(tuple(x.shape), x.dtype),
                         state)
        targets = decode_state_shardings(mesh, rules, cfg, specs)
        dp = set(dp_axes(mesh))

        def spread(pls):
            """A state leaf's non-data-parallel sharded dims."""
            return {i: d for i, d in sharded_dims(mesh, pls).items()
                    if mesh.mesh_dim_names[i] not in dp}

        def take(path, x, target):
            _, pls = target
            t = _to(x, mesh, pls)
            if local(path):
                return t
            return gather_dims(t, mesh, spread(pls))

        def back(path, t, like, target):
            _, pls = target
            if not local(path):
                t = cut_dims(t, mesh, spread(pls))
            return DTensor.from_local(t, mesh, pls, run_check=False,
                                      shape=like.shape,
                                      stride=contiguous_stride(like.shape))

        local_s = _walk(take, state, targets)
        compute, tp = _serve_setup(cfg, mesh, rules, params, 1,
                                   decode=True)
        logits, new = make_decode_step(
            cfg, shard=shard, moe_path=moe_path, scan_unroll=scan_unroll,
            moe_groups=local_moe_groups(cfg, B, moe_groups, split),
            attn_dist=attn_dist, tp=tp)(compute, local_s, local_b)
        new = _walk(back, new, state, targets)
        return _logits_out(cfg, mesh, logits, row_pls, B), new

    return decode


def _state_heads(cfg: ModelConfig, mesh, rules: Rules) -> dict:
    """{decode state leaf: its heads} of the recurrent states a rank holds
    its heads of: the ``ssd`` states where the Mamba2 mixers split, the
    ``wkv`` states where the RWKV6 time-mixes do."""
    out = {}
    if mamba_split_positions(cfg, mesh, rules):
        out["ssd"] = cfg.ssm_heads
    if any(p.endswith(".tm") for p in rwkv_split_positions(cfg, mesh,
                                                           rules)):
        out["wkv"] = cfg.rwkv_heads
    return out


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
                cast_params_bf16=cast_params_bf16, moe_path=moe_path,
                grad_hook=grad_hook is not None,
                guarded=guarded_positions(cfg, mesh, rules),
                expert_split=expert_split_positions(cfg, mesh, rules),
                mamba_split=mamba_split_positions(cfg, mesh, rules),
                rwkv_split=rwkv_split_positions(cfg, mesh, rules),
                in_proj_route=in_proj_route(cfg, mesh, rules, shape.kind),
                kv_chunks=kv_cache_chunks(cfg, mesh, rules, shape.kind,
                                          shape.seq_len))


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
