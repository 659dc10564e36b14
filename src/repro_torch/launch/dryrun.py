"""Dry run: account every (arch x input shape x mesh) cell of the port on
the production meshes, with no card, no process group and no JAX; record
per-device memory, operations, bytes and collectives, and a roofline on
one NVIDIA H100, to JSON.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/dryrun]

The twin of ``repro.launch.dryrun``, which lowers and compiles each cell
for 256 or 512 placeholder TPU devices and reads XLA's analyses and HLO
text (``hlo_cost``). Nothing is compiled here: the cell
(``launch/cells.build_cell``, its args meta tensors on a ``MeshShape``)
is counted from its config, shapes and placements, as the cell's ``fn``
would run it (see ``launch/cells.py``):

  * operations: the projections' matrix products (2 in x out a token per
    weight; MoE experts over their capacity slots, a rank's experts or
    columns; a split Mamba2 mixer's ``in_proj`` on the columns it
    multiplies by; a split RWKV6 part's projections on its columns or
    rows, its lerp and decay inputs whole), attention (on the busiest
    rank's head slot) and the scans (on a rank's SSD and WKV heads) by
    the formulas of ``chip_smoke.py``'s bounds, the LM head on
    every token in training and on the last one in serving; a training
    step adds the backward (2x the forward's products, 2.5x attention's)
    and, with remat, the forward again (and the chunked loss's logits);
  * bytes: each pass's weights in the compute dtype, each product's
    inputs and outputs, attention's q, k, v and output, the scans'
    inputs, outputs and states, the gradients' writes, their reduction,
    and AdamW on this rank's shards (read p, g, m, v; write p, m, v);
  * collectives (ring model, wire bytes a device receives): the all-gather
    of each parameter to whole (once a step), the gradients' all-reduce
    over every mesh dim, the batch's gather, the scalar all-reduces, the
    MoE router's token means, the MoE combine's sums over ``model`` and
    the 2D expert buffer's gathers over ``data``, a split mixer's norm
    sums over ``model`` (and, in decode, its projection's all-gather), a
    split RWKV6 channel-mix's reduce-scatter and all-gather, a split
    attention's all-to-alls between its column blocks and head slots where
    they differ (the wire a rank receives: the busiest rank's, or
    ``account(rank=)``'s); a decode step's gather of the sequence shards,
    or, with the distributed flash-decode, its q columns' gather and its
    three stats all-reduces a layer;
  * memory: the argument, output and temporary bytes a device holds.

No option changes a number here by pretending to run: ``--keep-hlo`` has
no meaning and is refused.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from ..arch import model as M
from ..arch.moe import dispatch_geometry
from ..arch.params import tree_leaves
from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..arch.layers import kv_range
from ..distributed.sharding import (batch_shardings, head_slots,
                                    param_shardings, rows_only, serve_rules,
                                    sharded_dims, sharded_extent,
                                    slot_splits)
from .cells import (Cell, LeafPlan, build_cell, cell_shardings,
                    leaf_plans, local_moe_groups, model_dim, row_dims,
                    row_mesh, seq_parallel, train_split)
from ..arch.mamba2 import _dims as mamba_dims
from .mesh import make_production_mesh

# one NVIDIA H100 80GB HBM3 at its 700 W limit (NVIDIA's data sheet, SXM,
# dense rates): the card every rate of this roofline is of
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12        # bf16 / fp16 tensor cores, dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink, bytes/s each way (per-device wire bytes)
SSD_CHUNK, WKV_CHUNK = 64, 32


@dataclass
class Count:
    flops: float = 0.0
    bytes: float = 0.0
    attention_flops: float = 0.0     # the attention core's share of flops
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(self.collectives.values())

    def coll(self, kind: str, wire: float, n: int = 1) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0.0) + wire
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + n


def _nbytes(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def _projections(cfg, expert_apps: float):
    """(path, in, out, applications a token) of every projection weight a
    token passes through once: the ParamSpecs of init "normal" with two or
    more dims past the stacked period axis (MoE experts at
    ``expert_apps`` of ``num_experts``; the shared block once a
    period)."""
    specs = M.build_param_specs(cfg)
    out = []

    def walk(tree, path, per_periods):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,), per_periods)
            return
        shape = tree.shape[1:] if path[0] == "blocks" else tree.shape
        if tree.init != "normal" or len(shape) < 2:
            return
        apps = cfg.num_periods if path[0] == "blocks" or per_periods else 1
        batch = math.prod(shape[:-2])
        if "moe" in path and path[-1] in ("w_gate", "w_up", "w_down") \
                and "shared" not in path:
            batch = expert_apps              # of the E stacked experts
        out.append((path, shape[-2], shape[-1], apps * batch))

    for key in ("blocks", "shared"):
        if key in specs:
            walk(specs[key], (key,), key == "shared")
    return out


@dataclass
class MoESplit:
    """How a MoE block's experts lie on a rank: over ``model`` by experts
    (``experts``, the extent) or by columns (``cols``), their columns over
    the data axes (``dp``: the extents, innermost first; the expert
    buffer's groups gathered over them), and whether the shared expert
    splits its columns (``shared``)."""
    experts: int = 1
    cols: int = 1
    dp: tuple = ()
    shared: bool = False

    @property
    def split(self) -> bool:
        """Whether the rank's routed output is a part of a sum over
        ``model``."""
        return self.experts > 1 or self.cols > 1


@dataclass
class Layout:
    """What a cell's ranks compute on (``cells.leaf_plans``): ``tp`` the
    model extent, ``seq`` sequence parallelism, per pattern position
    whether the attention splits on whole heads (``attn``), the MLP on
    its columns (``mlp``), how the MoE experts split (``moe``) and whether
    a Mamba2 mixer splits its SSD heads (``mamba``), which RWKV6 parts
    split (``rwkv``: ``"tm"``, ``"cm"`` by position), whether Zamba2's
    shared attention and MLP split (``shared``: (attention, MLP)),
    whether the embedding table (``embed``) and the LM head (``vocab``)
    hold vocab shards, ``nkv``, the KV heads a rank's q heads read (the
    most over the ranks), a split mixer's ``in_proj`` route
    (``cells.in_proj_route``), ``heads``, the q heads of the busiest
    rank's head slot where the attention splits (``head_slots``), and
    ``rank``, the model coordinate whose all-to-all wire is counted (None:
    the most over the ranks)."""
    plans: list
    shapes: list
    tp: int
    seq: bool
    attn: dict
    mlp: dict
    embed: bool
    vocab: bool
    nkv: int
    moe: dict = field(default_factory=dict)
    mamba: dict = field(default_factory=dict)
    shared: tuple = (False, False)
    route: str = ""
    rwkv: dict = field(default_factory=dict)
    heads: int = 0
    rank: Optional[int] = None

    @property
    def ssd_split(self) -> int:
        """How many ranks share a mixer's SSD heads: ``tp`` where the
        mixers split, else 1."""
        return self.tp if any(self.mamba.values()) else 1

    @property
    def wkv_split(self) -> int:
        """How many ranks share a time-mix's WKV heads: ``tp`` where the
        time-mixes split, else 1."""
        return self.tp if any("tm" in v for v in self.rwkv.values()) else 1


def layout(cell: Cell, seq_len: int, rank: Optional[int] = None) -> Layout:
    cfg, mesh = cell.cfg, cell.mesh
    seq = cell.kind != "decode" and seq_parallel(mesh, cell.rules,
                                                  seq_len)
    plans = leaf_plans(cfg, mesh, cell.rules, seq=seq,
                       decode=cell.kind == "decode")
    specs = M.build_param_specs(cfg)
    shapes = [s.shape for s in tree_leaves(specs)]
    m = model_dim(mesh)
    tp = mesh.shape[m] if m is not None else 1
    split = {p.path: m is not None and m in sharded_dims(mesh, p.placements)
             and m not in p.upfront for p in plans}
    attn = {f"pos{j}": split.get(("blocks", f"pos{j}", "attn", "wq"), False)
            for j in range(len(cfg.pattern))}
    mlp = {f"pos{j}": split.get(("blocks", f"pos{j}", "mlp", "w_down"),
                                False) for j in range(len(cfg.pattern))}
    head = ("embed",) if cfg.tie_embeddings and "embed" in specs \
        else ("lm_head",)
    shared = (split.get(("shared", "attn", "wq"), False),
              split.get(("shared", "mlp", "w_down"), False))
    nkv, heads = cfg.num_kv_heads, 0
    if any(attn.values()) or shared[0]:
        slots = [head_slots(cfg.num_heads, tp, r) for r in range(tp)]
        heads = max(n for _, n in slots)
        nkv = max(b - a for a, b in (kv_range(cfg, lo, n)
                                     for lo, n in slots))
    by_path = {p.path: p for p in plans}
    moe = {}
    for j, kind in enumerate(cfg.pattern):
        plan = by_path.get(("blocks", f"pos{j}", "moe", "w_gate"))
        if kind != "attn_moe" or plan is None:
            continue
        dims = sharded_dims(mesh, plan.placements)
        on_m = dims.get(m) if m not in plan.upfront else None
        moe[f"pos{j}"] = MoESplit(
            experts=mesh.shape[m] if on_m == 1 else 1,
            cols=mesh.shape[m] if on_m == 3 else 1,
            dp=tuple(mesh.shape[i] for i in sorted(plan.stationary,
                                                   reverse=True)),
            shared=split.get(("blocks", f"pos{j}", "moe", "shared",
                              "w_down"), False))
    mamba = {pos: pos in cell.mamba_split for j, kind in
             enumerate(cfg.pattern) if kind == "mamba2"
             for pos in (f"pos{j}",)}
    rwkv = {f"pos{j}": tuple(part for part in ("tm", "cm")
                             if f"pos{j}.{part}" in cell.rwkv_split)
            for j, kind in enumerate(cfg.pattern) if kind == "rwkv6"}
    return Layout(plans, shapes, tp, seq, attn, mlp,
                  split.get(("embed",), False), split.get(head, False), nkv,
                  moe, mamba, shared, cell.in_proj_route, rwkv, heads, rank)


def _in_proj_cols(cfg, lay: Layout) -> float:
    """The share of ``in_proj``'s columns a split mixer multiplies by on a
    rank: its column shard on the activation route, else its heads' z, x
    and dt and the whole B and C."""
    di, H, N, _, proj = mamba_dims(cfg)
    if lay.route == "activation":
        return 1.0 / lay.tp
    hl = H // lay.tp
    return (2 * hl * cfg.ssm_head_dim + 2 * N + hl) / proj


def _split(path, lay: Layout, cfg, cache) -> tuple:
    """(in, out) width factors of a projection on one rank, and the factor
    of its applications a token (a MoE rank's experts, and the groups it
    gathers). ``cache``: whether the pass writes every KV head's k/v
    (True), none (False), or every KV head's at the rank's sequence chunk
    (``"chunks"``, a prefill on split heads)."""
    if path[0] == "shared":
        pos, part, leaf = None, path[1], path[-1]
        attn, mlp = lay.shared
    elif path[0] == "blocks":
        pos, part, leaf = path[1], path[2], path[-1]
        attn = lay.attn.get(pos, False)
        if part == "mlp":
            mlp = lay.mlp[pos]
        else:                       # the shared expert splits as the MLP
            mlp = part == "moe" and "shared" in path and pos in lay.moe \
                and lay.moe[pos].shared
    else:
        return 1.0, 1.0, 1.0
    if part == "attn" and attn:
        if leaf == "wq":
            return 1.0, 1.0 / lay.tp, 1.0
        if leaf == "wo":
            return 1.0 / lay.tp, 1.0, 1.0
        if leaf in ("wk", "wv") and cache is not True:
            # its q heads' KV heads, and for a prefill's cache every KV
            # head at its sequence chunk
            chunk = 1.0 / lay.tp if cache == "chunks" else 0.0
            return 1.0, lay.nkv / cfg.num_kv_heads + chunk, 1.0
    if mlp:
        if leaf in ("w_gate", "w_up", "w_in"):
            return 1.0, 1.0 / lay.tp, 1.0
        if leaf == "w_down":
            return 1.0 / lay.tp, 1.0, 1.0
    if part == "mixer" and lay.mamba.get(pos):
        if leaf == "in_proj":
            return 1.0, _in_proj_cols(cfg, lay), 1.0
        if leaf == "out_proj":
            return 1.0 / lay.tp, 1.0, 1.0
    if part in lay.rwkv.get(pos, ()):
        # row shards: ``wo`` and the channel-mix's ``wv``; column shards:
        # the other projections and the decay's channels of ``w_lora_B``;
        # the lerp's and the decay's low-rank inputs whole
        if leaf == "wo" or (part == "cm" and leaf == "wv"):
            return 1.0 / lay.tp, 1.0, 1.0
        if leaf in ("wr", "wk", "wv", "wg", "w_lora_B"):
            return 1.0, 1.0 / lay.tp, 1.0
    if part == "moe" and pos in lay.moe and "shared" not in path \
            and leaf != "router":
        ms = lay.moe[pos]
        dp = math.prod(ms.dp)
        cols = 1.0 / (ms.cols * dp)
        apps = dp / ms.experts
        return (1.0, cols, apps) if leaf != "w_down" else (cols, 1.0, apps)
    return 1.0, 1.0, 1.0


def _attn_layers(cfg) -> int:
    return cfg.num_periods * (cfg.pattern.count("attn")
                              + cfg.pattern.count("attn_moe")
                              + int(cfg.shared_attn_every_period))


def _attn_split(cfg, lay: Layout, decode_dist: bool = False) -> list:
    """(q heads a rank attends with, whether split, applications a token)
    of each attention kind: a block position's split on its head slot
    (``lay.heads``), or, with the distributed flash-decode, over its
    sequence (every head on a ``tp``-th of the keys: ``H / tp``); the
    shared block's likewise; whole, every head."""
    H = cfg.num_heads

    def kind(split: bool) -> tuple:
        if decode_dist:
            return H / lay.tp, True
        return (lay.heads, True) if split else (H, False)
    out = [(*kind(lay.attn[f"pos{j}"]), cfg.num_periods)
           for j, k in enumerate(cfg.pattern) if k in ("attn", "attn_moe")]
    if cfg.shared_attn_every_period:
        out.append((*kind(lay.shared[0]), cfg.num_periods))
    return out


def _slot_wire(cfg, lay: Layout) -> tuple:
    """The fused q columns a rank receives in one exchange onto its head
    slot and in one back to its column block (``TPContext.to_heads``,
    ``to_cols``): the rank ``lay.rank``'s, or the pair of the rank that
    receives the most."""
    H, hd, t = cfg.num_heads, cfg.head_dim, lay.tp
    m = slot_splits(H, hd, t)
    pairs = [(sum(m[s][r] for s in range(t) if s != r),
              sum(m[r][s] for s in range(t) if s != r)) for r in range(t)]
    return pairs[lay.rank] if lay.rank is not None else max(pairs, key=sum)


def _per_token(cfg, S: int, ctx: float, decode: bool, expert_apps: float,
               act: int, lay: Layout, cache, dist: bool = False):
    """Forward operations and activation bytes a token on one rank:
    (projection flops, projection activation bytes, attention flops,
    attention bytes, scan flops, scan bytes), activations of ``act``
    bytes."""
    p_flops = p_bytes = 0.0
    for path, i, o, n in _projections(cfg, expert_apps):
        fi, fo, fn = _split(path, lay, cfg, cache)
        p_flops += 2 * i * o * n * fn * fi * fo
        p_bytes += (i * fi + o * fo) * n * fn * act
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    a_flops = a_bytes = 0.0
    for heads, split, n in _attn_split(cfg, lay, dist):
        a_flops += n * 4 * heads * hd * ctx
        kv = lay.nkv if split and cache is not True else KV
        a_bytes += n * (2 * heads + 2 * kv) * hd * act
    s_flops = s_bytes = 0.0
    n_ssd = cfg.num_periods * cfg.pattern.count("mamba2")
    if n_ssd:              # a split mixer's scan and conv on its heads
        Hs = cfg.ssm_heads // lay.ssd_split
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        c = min(SSD_CHUNK, S)
        per = 4 * P * N if decode else 2 * c * (N + P) + 4 * P * N
        s_flops += n_ssd * Hs * per
        conv_ch = Hs * P + 2 * N
        s_flops += n_ssd * 2 * cfg.ssm_conv * conv_ch
        s_bytes += n_ssd * (2 * Hs * P + 2 * N + Hs) * act
    n_wkv = cfg.num_periods * cfg.pattern.count("rwkv6")
    if n_wkv:              # a split time-mix's scan on its heads
        Hr, K = cfg.rwkv_heads // lay.wkv_split, cfg.rwkv_head_size
        c = min(WKV_CHUNK, S)
        per = 4 * K * K if decode else 3 * c * K + 2 * c * K + 4 * K * K
        s_flops += n_wkv * Hr * per
        s_bytes += n_wkv * (4 * Hr * K * act + Hr * K * 4)
    return p_flops, p_bytes, a_flops, a_bytes, s_flops, s_bytes


def _expert_apps(cfg, tokens: int, groups: int, moe_path: str) -> float:
    """Expert FFN applications a token costs: every (group, expert) slot
    of the dispatch computes, E C / Sg a token; the dense path runs all
    E experts on every token."""
    if "attn_moe" not in cfg.pattern:
        return 0.0
    if moe_path == "dense":
        return float(cfg.num_experts)
    _, Sg, C = dispatch_geometry(cfg, tokens, 1.25, groups)
    return cfg.num_experts * C / Sg


def _local_bytes(mesh, pls, shape, dtype) -> float:
    """A leaf's bytes on one device under placements ``pls``."""
    return math.prod(shape) * _nbytes(dtype) / sharded_extent(mesh, pls)


def _ring(kind: str, n: int, nbytes: float) -> float:
    """Wire bytes a device receives in one ring collective over ``n``
    ranks: an all-gather of ``nbytes`` a rank, a reduce-scatter of
    ``nbytes`` in, an all-reduce of ``nbytes``."""
    if kind == "all-gather":
        return (n - 1) * nbytes
    if kind == "reduce-scatter":
        return (n - 1) / n * nbytes
    return 2 * (n - 1) / n * nbytes


def _chain(c: Count, kind: str, ns, nbytes: float, times: int = 1) -> None:
    """All-gathers (or their reduce-scatters) over extents ``ns``, the
    innermost first, from a block of ``nbytes``: each the same wire."""
    for n in ns:
        c.coll(kind, times * (n - 1) * nbytes, times)
        nbytes *= n


def _all_reduce(mesh, nbytes: float) -> tuple:
    """Ring all-reduces over each mesh dim in turn: (wire bytes, count)."""
    dims = [m for m in mesh.shape if m > 1]
    return sum(_ring("all-reduce", m, nbytes) for m in dims), len(dims)


def _state_leaves(state, shardings, name: str = ""):
    """(leaf name, meta tensor, placements) of a decode state tree."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _state_leaves(v, shardings[k], k)
        return
    yield name, state, shardings[1]


def _elems(mesh, plan: LeafPlan, shape, dims=None) -> float:
    """A leaf's elements on one device with its ``upfront`` dims gathered
    (or, with ``dims``, those dims too)."""
    keep = {i for i in sharded_dims(mesh, plan.placements)
            if i not in plan.upfront and (dims is None or i not in dims)}
    return math.prod(shape) / math.prod(mesh.shape[i] for i in keep)


def _inner_first(mesh, dims) -> list:
    return [mesh.shape[i] for i in sorted(dims, reverse=True)]


def _weights(cell: Cell, lay: Layout, c: Count, nb: int, grad: bool,
             fwd: int, upfront: bool = True) -> dict:
    """The parameters' gathers: ``upfront`` once a call (param dtype;
    counted where ``upfront``), the top-level FSDP ones once a pass and
    each period's ``fwd`` times a pass (``nb`` bytes an element), their
    reduce-scatters once where ``grad``. Returns the bytes: ``device``
    (as the device computes on the weights), ``period`` (one period's
    gathered), ``top`` (the top-level leaves gathered), ``upfront``, and
    ``gathered``, what a device holds gathered at once."""
    cfg, mesh = cell.cfg, cell.mesh
    pb = _nbytes(tree_leaves(cell.args[0])[0].dtype)
    out = {"device": 0.0, "period": 0.0, "upfront": 0.0, "top": 0.0}
    for plan, shape in zip(lay.plans, lay.shapes):
        local = math.prod(shape) / sharded_extent(mesh, plan.placements)
        if plan.upfront:
            if upfront:
                _chain(c, "all-gather", _inner_first(mesh, plan.upfront),
                       local * pb)
            out["upfront"] += _elems(mesh, plan, shape) * pb
        computed = _elems(mesh, plan, shape, plan.fsdp)
        out["device"] += computed * nb
        if not plan.fsdp:
            continue
        block = plan.path[0] == "blocks"
        per = _elems(mesh, plan, shape) * nb / (cfg.num_periods if block
                                                else 1)
        ns = _inner_first(mesh, plan.fsdp)
        times = fwd if block else 1
        reps = cfg.num_periods if block else 1
        _chain(c, "all-gather", ns, per, times * reps)
        if grad:
            _chain(c, "reduce-scatter", ns, per, reps)
        if block:
            out["period"] += computed * nb / cfg.num_periods
        else:
            out["top"] += computed * nb
    out["gathered"] = out["upfront"] + out["period"] + out["top"]
    return out


def _parts(cfg, lay: Layout) -> list:
    """(sharded, input width, the MoE block's ``MoESplit`` or None) of
    every part a period runs, in order: an attention block's attention and
    its MLP (or MoE), a Mamba2 mixer, RWKV6's time and channel mixes (a
    split channel-mix's ``sharded`` is ``"gate"``: ``_activations``),
    Zamba2's shared attention and MLP."""
    d = cfg.d_model
    out = []
    for j, kind in enumerate(cfg.pattern):
        pos = f"pos{j}"
        if kind in ("attn", "attn_moe"):
            out.append((lay.attn[pos], d, None))
            if kind == "attn":
                out.append((lay.mlp[pos], d, None))
            else:
                out.append((False, d, lay.moe.get(pos, MoESplit())))
        elif kind == "mamba2":
            out.append((lay.mamba.get(pos, False), d, None))
        else:
            parts = lay.rwkv.get(pos, ())
            out += [("tm" in parts, d, None),
                    ("gate" if "cm" in parts else False, d, None)]
    if cfg.shared_attn_every_period:
        out += [(lay.shared[0], 2 * d, None), (lay.shared[1], 2 * d, None)]
    return out


def _moe_part(c: Count, cfg, ms: MoESplit, t: int, seq: bool, rows: int,
              S: int, act: int, fwd: int, grad: bool) -> None:
    """A MoE block's collectives over ``model`` in one pass of ``rows`` x
    ``S`` tokens (``arch/moe.py``): the f32 combine's sum where the
    experts split (an all-reduce, or under sequence parallelism a
    reduce-scatter) and the shared expert's partial sums, each ``fwd``
    times; backward, the input's and the gates' sums (the copy-ins' all-
    reduces; under sequence parallelism the sequence gather's
    reduce-scatter, the gates' all-reduce and the outputs' all-gathers)."""
    tok = rows * S
    x = tok * cfg.d_model * act
    out32 = tok * cfg.d_model * 4
    gates = tok * cfg.num_experts_per_tok * 4
    outs = ([out32] if ms.split else []) + ([x] if ms.shared else [])
    if seq:
        c.coll("all-gather", fwd * _ring("all-gather", t, x / t), fwd)
        for o in outs:
            c.coll("reduce-scatter", fwd * _ring("reduce-scatter", t, o),
                   fwd)
        if grad:
            c.coll("reduce-scatter", _ring("reduce-scatter", t, x))
            c.coll("all-reduce", _ring("all-reduce", t, gates))
            for o in outs:
                c.coll("all-gather", _ring("all-gather", t, o / t))
        return
    for o in outs:
        c.coll("all-reduce", fwd * _ring("all-reduce", t, o), fwd)
    if grad and outs:
        c.coll("all-reduce", _ring("all-reduce", t, x))
        if ms.split:
            c.coll("all-reduce", _ring("all-reduce", t, gates))


def _moe_groups(c: Count, cfg, lay: Layout, tokens: int, groups: int,
                act: int, fwd: int = 1, grad: bool = False) -> None:
    """The serving rules' 2D expert shards in one pass of ``tokens`` (a
    rank's, in ``groups`` token groups): each MoE block's expert buffer
    (its experts, every group's C slots) all-gathered over the data axes
    that split the experts' columns, the innermost first, and its partial
    products reduce-scattered back, the outermost first, ``fwd`` times;
    the backward's are the same (the gather's backward reduce-scatters,
    the reduce-scatter's all-gathers)."""
    times = fwd + int(grad)
    for ms in lay.moe.values():
        if not ms.dp:
            continue
        G, _, C = dispatch_geometry(cfg, tokens, 1.25, groups)
        buf = cfg.num_experts / ms.experts * G * C * cfg.d_model * act
        for _ in range(cfg.num_periods):
            _chain(c, "all-gather", ms.dp, buf, times)
            whole = buf * math.prod(ms.dp)
            for n in reversed(ms.dp):
                c.coll("reduce-scatter",
                       times * _ring("reduce-scatter", n, whole), times)
                whole /= n


def _activations(c: Count, cfg, lay: Layout, rows: int, S: int, act: int,
                 fwd: int, grad: bool, slots: bool = True) -> None:
    """The residual stream's collectives over ``model`` in one pass of
    ``rows`` x ``S`` tokens: the embedding's vocab sum (or sequence
    scatter) and, for each part of each period, the TP partial sums (an
    all-reduce out, and its copy-in's all-reduce backward), or under
    sequence parallelism the all-gather in and the reduce-scatter out
    (or this rank's shard kept), and, where ``slots``, a split
    attention's exchanges onto its head slots (``_slots``). Forward
    collectives inside a period run ``fwd`` times (the remat
    recompute)."""
    t = lay.tp
    if t == 1:
        return
    tok = rows * S * act
    if lay.embed and cfg.frontend != "frames":
        if lay.seq:
            c.coll("reduce-scatter", _ring("reduce-scatter", t, tok * cfg.d_model))
            if grad:
                c.coll("all-gather", _ring("all-gather", t,
                                           tok * cfg.d_model / t))
        else:
            c.coll("all-reduce", _ring("all-reduce", t, tok * cfg.d_model))
    for sharded, width, ms in _parts(cfg, lay):
        for _ in range(cfg.num_periods):
            if ms is not None:
                _moe_part(c, cfg, ms, t, lay.seq, rows, S, act, fwd, grad)
                continue
            if lay.seq:
                c.coll("all-gather", fwd * _ring("all-gather", t,
                                                 tok * width / t), fwd)
                if grad:
                    c.coll("reduce-scatter",
                           _ring("reduce-scatter", t, tok * width))
            elif sharded and grad:
                c.coll("all-reduce", _ring("all-reduce", t, tok * width))
            if sharded == "gate":
                _gate(c, t, lay.seq, tok * cfg.d_model, fwd, grad)
            elif sharded and lay.seq:
                c.coll("reduce-scatter", fwd * _ring(
                    "reduce-scatter", t, tok * cfg.d_model), fwd)
                if grad:
                    c.coll("all-gather", _ring("all-gather", t,
                                               tok * cfg.d_model / t))
            elif sharded:
                c.coll("all-reduce", fwd * _ring("all-reduce", t,
                                                 tok * cfg.d_model), fwd)
    _mixers(c, cfg, lay, rows * S, act, fwd, grad)
    if slots:
        _slots(c, cfg, lay, rows * S, act, fwd, grad)


def _slots(c: Count, cfg, lay: Layout, tokens: int, act: int, fwd: int,
           grad: bool) -> None:
    """A split attention's all-to-alls between its q column blocks and
    head slots in one pass of ``tokens`` (the whole sequence under
    sequence parallelism): q onto the slot and the output back, ``fwd``
    times; backward, the output's gradient onto the slot and q's back
    (``_slot_wire``'s columns each)."""
    n = cfg.num_periods * (sum(lay.attn[f"pos{j}"] for j, k in
                               enumerate(cfg.pattern)
                               if k in ("attn", "attn_moe"))
                           + int(cfg.shared_attn_every_period
                                 and lay.shared[0]))
    if not n or cfg.num_heads % lay.tp == 0:     # the blocks are the slots
        return
    into, back = _slot_wire(cfg, lay)
    times = fwd + int(grad)
    c.coll("all-to-all", n * times * (into + back) * tokens * act,
           2 * n * times)


def _gate(c: Count, t: int, seq: bool, x: float, fwd: int,
          grad: bool) -> None:
    """A split RWKV6 channel-mix's way out (``TPContext.gate``) in one pass
    whose output is ``x`` bytes on each rank: ``kv``'s partial sums
    reduce-scattered onto the rank's columns and the gated product
    all-gathered, ``fwd`` times; backward, the reduce-scatter's all-gather
    and, under sequence parallelism, the product gather's reduce-scatter
    (else that gradient is cut, no collective)."""
    c.coll("reduce-scatter", fwd * _ring("reduce-scatter", t, x), fwd)
    c.coll("all-gather", fwd * _ring("all-gather", t, x / t), fwd)
    if grad:
        c.coll("all-gather", _ring("all-gather", t, x / t))
        if seq:
            c.coll("reduce-scatter", _ring("reduce-scatter", t, x))


def _mixers(c: Count, cfg, lay: Layout, tokens: int, act: int, fwd: int,
            grad: bool) -> None:
    """The split Mamba2 mixers' own collectives over ``model`` in one pass
    of ``tokens`` (``arch/mamba2.py``): the gated RMSNorm's f32 sum of
    squares (an all-reduce, ``fwd`` times; its copy-in's all-reduce
    backward) and, on the activation route (decode), the projection's
    all-gather."""
    n = cfg.num_periods * sum(lay.mamba.values())
    t = lay.tp
    if not n:
        return
    c.coll("all-reduce", n * fwd * _ring("all-reduce", t, tokens * 4),
           n * fwd)
    if grad:
        c.coll("all-reduce", n * _ring("all-reduce", t, tokens * 4), n)
    if lay.route == "activation":             # decode: no backward
        block = tokens * mamba_dims(cfg)[4] / t * act
        c.coll("all-gather", n * fwd * _ring("all-gather", t, block),
               n * fwd)


def account(cell: Cell, rank: Optional[int] = None) -> dict:
    """The per-device count of one cell (see the module's docstring):
    ``{"count": Count, "split": slices of the batch, "rows_per_device",
    "memory": {...}}``; the all-to-all wire of the model coordinate
    ``rank`` (None: the rank that receives the most)."""
    import torch
    cfg, mesh, rules = cell.cfg, cell.mesh, cell.rules
    act = _nbytes(getattr(torch, cfg.dtype))
    specs = M.build_param_specs(cfg)
    p_shapes = [s.shape for s in tree_leaves(specs)]
    p_pls = [sh[1] for sh in tree_leaves(param_shardings(mesh, rules,
                                                         specs))]
    pdt = tree_leaves(cell.args[0])[0].dtype
    pbytes = _nbytes(pdt)
    whole_params = sum(math.prod(s) for s in p_shapes) * pbytes
    local_params = sum(_local_bytes(mesh, pls, s, pdt)
                       for pls, s in zip(p_pls, p_shapes))
    m = model_dim(mesh)
    tp = mesh.shape[m] if m is not None else 1
    head = 2 * cfg.d_model * cfg.vocab_size     # LM head flops a token
    c = Count()
    batch_specs = {k: M.TensorSpec(tuple(t.shape), t.dtype)
                   for k, t in cell.args[-1].items()}
    b_pls = {k: sh[1] for k, sh in
             batch_shardings(mesh, rules, batch_specs).items()}
    batch_whole = sum(math.prod(t.shape) * _nbytes(t.dtype)
                      for t in batch_specs.values())
    batch_local = sum(_local_bytes(mesh, b_pls[k], t.shape, t.dtype)
                      for k, t in batch_specs.items())
    lay = layout(cell, cell.shape.seq_len, rank)
    if lay.vocab:
        head /= tp
    if cell.kind == "train":
        mem = _train(cell, c, act, head, lay, local_params / pbytes, pbytes,
                     batch_whole, batch_local, b_pls)
    else:
        mem = _serve(cell, c, act, head, lay, local_params, batch_local,
                     b_pls)
    m_ = mem["memory"]
    m_["param_bytes"] = local_params
    m_["peak_per_device_bytes"] = (m_["argument_bytes"] + m_["output_bytes"]
                                   + m_["temp_bytes"] - m_["alias_bytes"])
    mem["layout"] = {"model_extent": tp, "sequence_parallel": lay.seq,
                     "attention_split": sorted(k for k, v in lay.attn.items()
                                               if v),
                     "q_heads_per_rank": lay.heads,
                     "guarded": list(cell.guarded),
                     "vocab_split": lay.vocab,
                     "kv_cache_chunks": cell.kv_chunks,
                     "mamba_split": {
                         "positions": list(cell.mamba_split),
                         "ssd_heads_per_rank": cfg.ssm_heads // lay.ssd_split
                         if cell.mamba_split else 0,
                         "in_proj_route": cell.in_proj_route},
                     "rwkv_split": {
                         "parts": list(cell.rwkv_split),
                         "wkv_heads_per_rank": cfg.rwkv_heads
                         // lay.wkv_split if lay.wkv_split > 1 else 0},
                     "shared_split": {"attention": lay.shared[0],
                                      "mlp": lay.shared[1]},
                     "expert_split": {pos: {"experts": ms.experts,
                                            "columns_model": ms.cols,
                                            "columns_data": list(ms.dp)}
                                      for pos, ms in lay.moe.items()}}
    return mem


def _train(cell, c, act, head, lay, local_elems, pbytes, batch_whole,
           batch_local, b_pls) -> dict:
    cfg, mesh = cell.cfg, cell.mesh
    B, S = cell.shape.global_batch, cell.shape.seq_len
    mb = cell.microbatches
    rm = row_mesh(mesh)
    ext = rm.size()
    split = train_split(rm, B // mb)
    rows = B // mb // split                      # a device's, a microbatch
    groups = local_moe_groups(cfg, B // mb * S, mesh.size(), split)
    ctx = (S + 1) / 2 if cfg.causal else S
    pf, pb, af, ab, sf, sb = _per_token(
        cfg, S, ctx, False, _expert_apps(cfg, rows * S, groups,
                                         cell.moe_path), act, lay, False)
    tokens = mb * rows * S
    remat = int(cell.remat)
    fwd = 1 + remat
    chunks = max(1, min(16, S // 512))
    while S % chunks:
        chunks -= 1
    recompute_head = int(chunks > 1)
    vocab = cfg.vocab_size / (lay.tp if lay.vocab else 1)
    # forward, backward (2x the products, 2.5x attention's), recompute
    c.attention_flops = tokens * af * (3.5 + remat)
    c.flops = tokens * ((pf + sf) * (3 + remat) + head * (3 + recompute_head)) \
        + c.attention_flops
    # the batch's rows: gathered whole unless one microbatch is cut as
    # the data axes cut the batch
    local = mb == 1 and split == ext
    if not local:
        for k, t in cell.args[-1].items():
            pls = b_pls[k]
            local = math.prod(t.shape) * _nbytes(t.dtype) \
                / sharded_extent(mesh, pls)
            _chain(c, "all-gather", _inner_first(mesh, sharded_dims(
                mesh, pls)), local)
    nb = 2 if cell.cast_params_bf16 else pbytes
    for i in range(mb):
        w = _weights(cell, lay, c, nb, True, fwd, upfront=i == 0)
        _activations(c, cfg, lay, rows, S, act, fwd, True)
        _moe_groups(c, cfg, lay, rows * S, groups, act, fwd, True)
        _loss(c, cfg, lay, rows, S, act, chunks)
    w_compute = w["device"] / nb * act
    passes = 3 + remat          # forward, recompute, the two backward GEMMs
    c.bytes = (tokens * ((pb + ab + sb) * passes
                         + vocab * 4 * 2 * (2 + recompute_head))
               + mb * (w_compute * passes + w["device"] / nb * pbytes)
               # the gradients' reductions and cut: read, write, read
               + 3 * local_elems * pbytes
               # AdamW: read p, g, m, v and write p, m, v (f32 moments)
               + local_elems * (3 * pbytes + 4 * 4))
    for plan, shape in zip(lay.plans, lay.shapes):
        g = _elems(mesh, plan, shape, plan.fsdp) * pbytes
        g /= math.prod(mesh.shape[i] for i in plan.fsdp)
        for i in row_dims(mesh):
            if i not in plan.fsdp and i not in plan.stationary:
                c.coll("all-reduce", _ring("all-reduce", mesh.shape[i], g))
        if plan.model_sum:
            c.coll("all-reduce", _ring("all-reduce", lay.tp, g))
        if cell.grad_hook:
            _chain(c, "all-gather", _inner_first(
                mesh, sharded_dims(mesh, plan.placements)),
                math.prod(shape) * pbytes / sharded_extent(
                    mesh, plan.placements))
    n_metrics = 2 + 2 * ("attn_moe" in cfg.pattern)   # loss, ce, aux
    for i in row_dims(mesh):
        c.coll("all-reduce", n_metrics * _ring("all-reduce", mesh.shape[i],
                                               4), n_metrics)
    wire, n = _all_reduce(mesh, 4)                    # the clip's norm
    c.coll("all-reduce", wire, n)
    n_moe = cfg.num_periods * cfg.pattern.count("attn_moe")
    if n_moe:      # the router's two token means a pass, me's gradient
        wire, n = _all_reduce(mesh, cfg.num_experts * 4)
        k = n_moe * mb * (2 * (1 + remat) + 1)
        c.coll("all-reduce", wire * k, n * k)
    local_params = local_elems * pbytes
    moments = 2 * local_elems * 4 + 4                  # f32 mu, nu; step
    resid_rows = rows * S / (lay.tp if lay.seq else 1)
    residual = cfg.num_periods * resid_rows * cfg.d_model * act
    period = rows * S * (pb + ab + sb) / cfg.num_periods
    logits = rows * (S // chunks) * vocab * 4 * 2
    # the gradients as reduced (upfront leaves whole, FSDP ones local),
    # accumulated over microbatches, and one period's gathered
    grads = sum(_elems(mesh, p, s) for p, s in zip(lay.plans, lay.shapes)) \
        * pbytes * (1 + (mb > 1)) + w["period"] / nb * pbytes
    batch = batch_local if local else batch_whole
    return {"count": c, "split": split, "rows_per_device": mb * rows,
            "memory": {"argument_bytes": local_params + moments
                       + batch_local,
                       "output_bytes": local_params + moments,
                       "temp_bytes": w["gathered"] + grads + residual
                       + period + logits + batch,
                       "alias_bytes": 0}}


def _loss(c: Count, cfg, lay: Layout, rows: int, S: int, act: int,
          chunks: int) -> None:
    """The head's and the vocab-parallel cross-entropy's collectives in a
    training pass: the max, the sum of exponentials and the label's logit
    of each chunk (again in a chunk's recompute), the head input's
    copy-in backward, or under sequence parallelism its sequence gather
    (or, with a whole head, the loss's sum over the ranks)."""
    t = lay.tp
    if t == 1:
        return
    if not lay.vocab:
        if lay.seq:
            c.coll("all-reduce", _ring("all-reduce", t, 4))
        return
    h = rows * S * cfg.d_model * act
    if lay.seq:
        c.coll("all-gather", _ring("all-gather", t, h / t))
        c.coll("reduce-scatter", _ring("reduce-scatter", t, h))
    times = 2 if chunks > 1 else 1
    csz = S // chunks
    c.coll("all-reduce", chunks * times * 3 * _ring("all-reduce", t,
                                                     rows * csz * 4),
           chunks * times * 3)
    if not lay.seq:
        c.coll("all-reduce", chunks * _ring("all-reduce", t, h / chunks),
               chunks)


def _serve(cell, c, act, head, lay, local_params, batch_local,
           b_pls) -> dict:
    import torch
    cfg, mesh = cell.cfg, cell.mesh
    B, S = cell.shape.global_batch, cell.shape.seq_len
    decode = cell.kind == "decode"
    split = sharded_extent(mesh, b_pls["frames" if "frames" in b_pls
                                        else "tokens"])
    rows = B // split
    tokens = rows * (1 if decode else S)
    groups = local_moe_groups(cfg, B * (1 if decode else S), mesh.size(),
                              split)
    ctx = S if decode else ((S + 1) / 2 if cfg.causal else S)
    cache = "chunks" if cell.kv_chunks else True
    pf, pb, af, ab, sf, sb = _per_token(
        cfg, S, ctx, decode, _expert_apps(cfg, tokens, groups,
                                          cell.moe_path), act, lay, cache,
        dist=decode and cell.dist_decode)
    heads = rows if cfg.is_decoder else rows * S
    c.attention_flops = tokens * af
    c.flops = tokens * (pf + sf) + c.attention_flops + heads * head
    if not decode and lay.route == "weight":
        # the conv state's tail from the whole in_proj's [x, B, C] columns
        conv_ch = mamba_dims(cfg)[3]
        c.flops += rows * cfg.num_periods * sum(lay.mamba.values()) \
            * 2 * (cfg.ssm_conv - 1) * cfg.d_model * conv_ch
    vocab = cfg.vocab_size / (lay.tp if lay.vocab else 1)
    logits = heads * vocab * 4
    pbytes = _nbytes(tree_leaves(cell.args[0])[0].dtype)
    w = _weights(cell, lay, c, pbytes, False, 1)
    w_compute = w["device"] / pbytes * act
    _activations(c, cfg, lay, rows, 1 if decode else S, act, 1, False,
                 slots=not (decode and cell.dist_decode))
    _moe_groups(c, cfg, lay, tokens, groups, act)
    gathered = w["gathered"]
    if not decode:
        if lay.seq and lay.tp > 1:          # the last token's gather
            c.coll("all-gather", _ring("all-gather", lay.tp,
                                       rows * S * cfg.d_model * act
                                       / lay.tp))
        specs = M.decode_state_specs(cfg, rows, S, getattr(torch,
                                                           cfg.dtype))
        # a split mixer's ssd state and a split time-mix's wkv state:
        # this rank's heads; a split attention's k/v: its sequence chunk
        split = {**lay.attn, "shared": lay.shared[0]}
        heads = {"ssd": lay.ssd_split, "wkv": lay.wkv_split}
        caches = sum(math.prod(t.shape) * _nbytes(t.dtype)
                     / (heads[name] if name in heads else lay.tp
                        if name in ("k", "v") and split.get(key)
                        and cache == "chunks" else 1)
                     for key, leaves in specs["caches"].items()
                     for name, t in leaves.items())
        c.bytes = w_compute + tokens * (pb + ab + sb) + logits \
            + caches * cfg.is_decoder
        return {"count": c, "split": split, "rows_per_device": rows,
                "memory": {"argument_bytes": local_params + batch_local,
                           "output_bytes": logits
                           + caches * cfg.is_decoder,
                           "temp_bytes": gathered + rows * S
                           * (pb + ab + sb) / cfg.num_periods,
                           "alias_bytes": 0}}
    dstate = cell.args[1]
    s_sh = cell_shardings(cell)[1]
    state_local = state_step = 0.0
    for name, t, pls in _state_leaves(dstate, s_sh):
        local = _local_bytes(mesh, pls, t.shape, t.dtype)
        state_local += local
        if cell.dist_decode and name in ("k", "v") \
                or name == "ssd" and lay.ssd_split > 1 \
                or name == "wkv" and lay.wkv_split > 1:
            state_step += local
            continue
        gathered_to = rows_only(mesh, pls)
        step = _local_bytes(mesh, gathered_to, t.shape, t.dtype)
        state_step += step
        n = sum(1 for m, a, b in zip(mesh.shape, pls, gathered_to)
                if m > 1 and a != b)
        if n:
            c.coll("all-gather", step - local, n)
    # the weights and every cache row read once, the new entries written
    c.bytes = w_compute + state_step + tokens * (pb + ab + sb) + logits
    t = lay.tp
    if cell.dist_decode and t > 1:
        H, hd = cfg.num_heads, cfg.head_dim
        for _, split_heads, n in _attn_split(cfg, lay):
            if split_heads:      # every rank's q columns
                c.coll("all-gather", n * _ring("all-gather", t,
                                               rows * H / t * hd * act), n)
            for nbytes in (rows * H * hd * 4, rows * H * 4, rows * H * 4):
                c.coll("all-reduce", n * _ring("all-reduce", t, nbytes), n)
    return {"count": c, "split": split, "rows_per_device": rows,
            "memory": {"argument_bytes": local_params + state_local
                       + batch_local,
                       "output_bytes": state_local + logits,
                       "temp_bytes": gathered + state_step,
                       "alias_bytes": 0}}


def roofline(count: Count) -> dict:
    """The least time one card (``CARD``) could take for the count: each
    term alone, and the one that dominates."""
    rl = {"compute_s": count.flops / PEAK_FLOPS,
          "memory_s": count.bytes / HBM_BW,
          "collective_s": count.collective_wire_bytes / LINK_BW}
    rl["dominant"] = max(rl, key=lambda k: rl[k])
    return rl


def _tag(arch: str, shape_name: str, mesh, multi_pod: bool,
         custom: bool) -> str:
    if custom:
        return f"{arch}__{shape_name}__" + "x".join(map(str, mesh.shape))
    return f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}"


def run_cell(arch: str, shape_name, *, multi_pod: bool, out_dir: Path,
             optimized: bool = False, mesh=None, **cell_kw) -> dict:
    """Account one cell on the production mesh (or ``mesh``: a
    ``MeshShape`` or ``DeviceMesh``), write its JSON to ``out_dir`` and
    return it. ``shape_name`` is a ``SHAPES`` key or a ``ShapeSpec``."""
    custom = mesh is not None
    mesh = mesh if custom else make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    t0 = time.time()
    if optimized:
        # weight-stationary serving + the distributed flash-decode for the
        # serve cells; sequence parallelism stays a per-cell lever for
        # training (rules=sp_rules(...))
        if shape.kind in ("decode", "prefill"):
            cell_kw.setdefault("rules", serve_rules("pod" in tuple(
                mesh.mesh_dim_names)))
            if shape.kind == "decode":
                cell_kw.setdefault("dist_decode", True)
    cell = build_cell(arch, shape, mesh, **cell_kw)
    acc = account(cell)
    cost = acc["count"]
    result = {
        "arch": cell.cfg.name, "shape": shape.name, "kind": cell.kind,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_devices": mesh.size(),
        "rules": cell.rules.name, "microbatches": cell.microbatches,
        "batch_split": acc["split"],
        "rows_per_device": acc["rows_per_device"],
        "t_account_s": time.time() - t0,
        "memory": acc["memory"],
        "layout": acc["layout"],
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "collective_wire_bytes": cost.collective_wire_bytes,
                 "collectives": dict(cost.collectives),
                 "collective_counts": dict(cost.collective_counts)},
        "roofline": {**roofline(cost), "card": CARD},
        "breakdown": {"attention_flops": cost.attention_flops},
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _tag(cell.cfg.name, shape.name, mesh, multi_pod, custom)
    with open(out_dir / f"{tag}.json", "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="refused: nothing is lowered to HLO here")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the optimized layouts (serve_rules + the "
                         "distributed flash-decode for serve cells)")
    args = ap.parse_args(argv)
    if args.keep_hlo:
        ap.error("--keep-hlo has no meaning in the port: the dry run "
                 "accounts each cell from its config and placements and "
                 "lowers nothing to HLO")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out_dir = Path(args.out)
    cells = []
    if args.all:
        for a in list_archs():
            cfg = get_config(a)
            for s in SHAPES.values():
                ok, why = shape_applicable(cfg, s)
                if ok:
                    cells.append((a, s.name))
                else:
                    print(f"SKIP {a} x {s.name}: {why}")
    else:
        cells = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
            if args.skip_existing and (out_dir / f"{tag}.json").exists():
                print(f"skip existing {tag}")
                continue
            try:
                r = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir,
                             optimized=args.optimized)
                rl = r["roofline"]
                print(f"OK  {tag}: mem/dev="
                      f"{r['memory']['peak_per_device_bytes'] / 2**30:.2f}GiB "
                      f"compute={rl['compute_s'] * 1e3:.2f}ms "
                      f"memory={rl['memory_s'] * 1e3:.2f}ms "
                      f"coll={rl['collective_s'] * 1e3:.2f}ms "
                      f"dom={rl['dominant']}", flush=True)
            except Exception as e:  # noqa: BLE001  (counted, then raised)
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
