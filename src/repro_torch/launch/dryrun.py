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
    weight; MoE experts over their capacity slots), attention and the
    scans by the formulas of ``chip_smoke.py``'s bounds, the LM head on
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
    MoE router's token means; a decode step's gather of the sequence
    shards, or, with the distributed flash-decode, its three stats
    all-reduces a layer;
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
from typing import Dict

from ..arch import model as M
from ..arch.moe import dispatch_geometry
from ..arch.params import tree_leaves
from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..distributed.sharding import (batch_shardings, param_shardings,
                                    rows_only, serve_rules, sharded_extent)
from .cells import (Cell, build_cell, cell_shardings, local_moe_groups,
                    train_split)
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
    """(in, out, applications a token) of every projection weight a token
    passes through once: the ParamSpecs of init "normal" with two or more
    dims past the stacked period axis (MoE experts at ``expert_apps`` of
    ``num_experts``; the shared block once a period)."""
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
        out.append((shape[-2], shape[-1], apps * batch))

    for key in ("blocks", "shared"):
        if key in specs:
            walk(specs[key], (key,), key == "shared")
    return out


def _attn_layers(cfg) -> int:
    return cfg.num_periods * (cfg.pattern.count("attn")
                              + cfg.pattern.count("attn_moe")
                              + int(cfg.shared_attn_every_period))


def _per_token(cfg, S: int, ctx: float, decode: bool, expert_apps: float,
               act: int):
    """Forward operations and activation bytes a token: (projection
    flops, projection activation bytes, attention flops, attention
    bytes, scan flops, scan bytes), activations of ``act`` bytes."""
    proj = _projections(cfg, expert_apps)
    p_flops = sum(2 * i * o * n for i, o, n in proj)
    p_bytes = sum((i + o) * n * act for i, o, n in proj)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = _attn_layers(cfg)
    a_flops = L * 4 * H * hd * ctx
    a_bytes = L * (2 * H + 2 * KV) * hd * act
    s_flops = s_bytes = 0.0
    n_ssd = cfg.num_periods * cfg.pattern.count("mamba2")
    if n_ssd:
        Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        c = min(SSD_CHUNK, S)
        per = 4 * P * N if decode else 2 * c * (N + P) + 4 * P * N
        s_flops += n_ssd * Hs * per
        conv_ch = cfg.d_inner + 2 * N
        s_flops += n_ssd * 2 * cfg.ssm_conv * conv_ch
        s_bytes += n_ssd * (2 * Hs * P + 2 * N + Hs) * act
    n_wkv = cfg.num_periods * cfg.pattern.count("rwkv6")
    if n_wkv:
        Hr, K = cfg.rwkv_heads, cfg.rwkv_head_size
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


def _gathers(mesh, pls, whole: float) -> tuple:
    """(wire bytes a device receives, collectives) to gather a leaf of
    ``whole`` bytes from ``pls``: whole minus local, one all-gather a
    sharded mesh dim of more than one rank."""
    from torch.distributed.tensor import Shard
    n = sum(1 for m, pl in zip(mesh.shape, pls)
            if isinstance(pl, Shard) and m > 1)
    return whole - whole / sharded_extent(mesh, pls), n


def _all_reduce(mesh, nbytes: float) -> tuple:
    """Ring all-reduces over each mesh dim in turn: (wire bytes, count)."""
    dims = [m for m in mesh.shape if m > 1]
    return sum(2 * (m - 1) / m * nbytes for m in dims), len(dims)


def _state_leaves(state, shardings, name: str = ""):
    """(leaf name, meta tensor, placements) of a decode state tree."""
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _state_leaves(v, shardings[k], k)
        return
    yield name, state, shardings[1]


def account(cell: Cell) -> dict:
    """The per-device count of one cell (see the module's docstring):
    ``{"count": Count, "split": slices of the batch, "rows_per_device",
    "memory": {...}}``."""
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
    w_compute = whole_params / pbytes * act     # each pass's weights
    head = 2 * cfg.d_model * cfg.vocab_size     # LM head flops a token
    c = Count()
    for pls, s in zip(p_pls, p_shapes):         # gathered whole, once a call
        wire, n = _gathers(mesh, pls, math.prod(s) * pbytes)
        if n:
            c.coll("all-gather", wire, n)
    batch_specs = {k: M.TensorSpec(tuple(t.shape), t.dtype)
                   for k, t in cell.args[-1].items()}
    b_pls = {k: sh[1] for k, sh in
             batch_shardings(mesh, rules, batch_specs).items()}
    batch_whole = sum(math.prod(t.shape) * _nbytes(t.dtype)
                      for t in batch_specs.values())
    batch_local = sum(_local_bytes(mesh, b_pls[k], t.shape, t.dtype)
                      for k, t in batch_specs.items())
    if cell.kind == "train":
        mem = _train(cell, c, act, head, whole_params, local_params / pbytes,
                     pbytes, w_compute, p_shapes, batch_whole, batch_local,
                     b_pls)
    else:
        mem = _serve(cell, c, act, head, whole_params, local_params,
                     w_compute, batch_local, b_pls)
    m = mem["memory"]
    m["param_bytes"] = local_params
    m["peak_per_device_bytes"] = (m["argument_bytes"] + m["output_bytes"]
                                  + m["temp_bytes"] - m["alias_bytes"])
    return mem


def _train(cell, c, act, head, whole_params, local_elems, pbytes,
           w_compute, p_shapes, batch_whole, batch_local, b_pls) -> dict:
    cfg, mesh = cell.cfg, cell.mesh
    B, S = cell.shape.global_batch, cell.shape.seq_len
    mb = cell.microbatches
    split = train_split(mesh, B // mb)
    rows = B // mb // split                      # a device's, a microbatch
    groups = local_moe_groups(cfg, B // mb * S, mesh.size(), split)
    ctx = (S + 1) / 2 if cfg.causal else S
    pf, pb, af, ab, sf, sb = _per_token(
        cfg, S, ctx, False, _expert_apps(cfg, rows * S, groups,
                                         cell.moe_path), act)
    tokens = mb * rows * S
    remat = int(cell.remat)
    chunks = max(1, min(16, S // 512))
    recompute_head = int(chunks > 1)
    # forward, backward (2x the products, 2.5x attention's), recompute
    c.flops = tokens * ((pf + sf) * (3 + remat) + af * (3.5 + remat)
                        + head * (3 + recompute_head))
    passes = 3 + remat          # forward, recompute, the two backward GEMMs
    c.bytes = (tokens * ((pb + ab + sb) * passes
                         + cfg.vocab_size * 4 * 2 * (2 + recompute_head))
               + mb * (w_compute * passes + whole_params)   # + dW written
               + 3 * whole_params         # the all-reduce's read / write, cut
               # AdamW: read p, g, m, v and write p, m, v (f32 moments)
               + local_elems * (3 * pbytes + 4 * 4))
    wire, n = _all_reduce(mesh, whole_params)
    c.coll("all-reduce", wire, n * len(p_shapes))
    if batch_local < batch_whole:
        c.coll("all-gather", batch_whole - batch_local, len(b_pls))
    n_metrics = 2 + 2 * ("attn_moe" in cfg.pattern)   # loss, ce, aux
    wire, n = _all_reduce(mesh, 4)
    c.coll("all-reduce", wire * (n_metrics + 1), n * (n_metrics + 1))
    n_moe = cfg.num_periods * cfg.pattern.count("attn_moe")
    if n_moe:      # the router's two token means a pass, me's gradient
        wire, n = _all_reduce(mesh, cfg.num_experts * 4)
        k = n_moe * mb * (2 * (1 + remat) + 1)
        c.coll("all-reduce", wire * k, n * k)
    local_params = local_elems * pbytes
    moments = 2 * local_elems * 4 + 4                  # f32 mu, nu; step
    residual = cfg.num_periods * rows * S * cfg.d_model * act
    period = rows * S * (pb + ab + sb) / cfg.num_periods
    logits = rows * (S // chunks) * cfg.vocab_size * 4 * 2
    grads = whole_params * (1 + (mb > 1))
    return {"count": c, "split": split, "rows_per_device": mb * rows,
            "memory": {"argument_bytes": local_params + moments
                       + batch_local,
                       "output_bytes": local_params + moments,
                       "temp_bytes": whole_params + grads + residual
                       + period + logits + batch_whole,
                       "alias_bytes": 0}}


def _serve(cell, c, act, head, whole_params, local_params, w_compute,
           batch_local, b_pls) -> dict:
    import torch
    cfg, mesh, rules = cell.cfg, cell.mesh, cell.rules
    B, S = cell.shape.global_batch, cell.shape.seq_len
    decode = cell.kind == "decode"
    split = sharded_extent(mesh, b_pls["frames" if "frames" in b_pls
                                        else "tokens"])
    rows = B // split
    tokens = rows * (1 if decode else S)
    groups = local_moe_groups(cfg, B * (1 if decode else S), mesh.size(),
                              split)
    ctx = S if decode else ((S + 1) / 2 if cfg.causal else S)
    pf, pb, af, ab, sf, sb = _per_token(
        cfg, S, ctx, decode, _expert_apps(cfg, tokens, groups,
                                          cell.moe_path), act)
    heads = rows if cfg.is_decoder else rows * S
    c.flops = tokens * (pf + af + sf) + heads * head
    logits = heads * cfg.vocab_size * 4
    if not decode:
        caches = sum(math.prod(t.shape) * _nbytes(t.dtype)
                     for t in tree_leaves(M.decode_state_specs(
                         cfg, rows, S, getattr(torch, cfg.dtype))["caches"]))
        c.bytes = w_compute + tokens * (pb + ab + sb) + logits \
            + caches * cfg.is_decoder
        return {"count": c, "split": split, "rows_per_device": rows,
                "memory": {"argument_bytes": local_params + batch_local,
                           "output_bytes": logits
                           + caches * cfg.is_decoder,
                           "temp_bytes": whole_params + rows * S
                           * (pb + ab + sb) / cfg.num_periods,
                           "alias_bytes": 0}}
    dstate = cell.args[1]
    s_sh = cell_shardings(cell)[1]
    state_local = state_step = 0.0
    for name, t, pls in _state_leaves(dstate, s_sh):
        local = _local_bytes(mesh, pls, t.shape, t.dtype)
        state_local += local
        if cell.dist_decode and name in ("k", "v"):
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
    if cell.dist_decode:         # o, m, l of every attention layer
        M_ = mesh.shape[tuple(mesh.mesh_dim_names).index("model")]
        L, H = _attn_layers(cfg), cfg.num_heads
        if M_ > 1:
            for nbytes in (rows * H * cfg.head_dim * 4, rows * H * 4,
                           rows * H * 4):
                c.coll("all-reduce", L * 2 * (M_ - 1) / M_ * nbytes, L)
    return {"count": c, "split": split, "rows_per_device": rows,
            "memory": {"argument_bytes": local_params + state_local
                       + batch_local,
                       "output_bytes": state_local + logits,
                       "temp_bytes": whole_params + state_step,
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
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "collective_wire_bytes": cost.collective_wire_bytes,
                 "collectives": dict(cost.collectives),
                 "collective_counts": dict(cost.collective_counts)},
        "roofline": {**roofline(cost), "card": CARD},
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
