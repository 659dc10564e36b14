"""Gloo process groups on the CPU for the port's multi-device tests: a
world of ``n`` spawned processes, each running one module-level function
of a test's worker module, its result saved for the parent. No JAX is
imported here, so the workers start with torch alone."""
from __future__ import annotations

import socket
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, target, world: int, port: int, out_dir: str,
           args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = target(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def run_world(target, world: int, out_dir, *args, timeout: float = 120.0):
    """Run ``target(rank, *args)`` in a gloo world of ``world`` spawned
    processes on 127.0.0.1 and return each rank's result, in rank order.
    Raises if a rank fails, and kills the world past ``timeout`` s."""
    out_dir = Path(out_dir)
    ctx = mp.start_processes(_entry, args=(target, world, _free_port(),
                                           str(out_dir), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo world of {world} still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------ the tests' world bodies

def sharding_world(rank: int) -> dict:
    """tests/test_torch_sharding.py: ``make_mesh``, ``placements`` and
    ``make_shard_fn`` in a world of 4."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.arch.params import ParamSpec
    from repro_torch.distributed.sharding import (baseline_rules,
                                                  make_shard_fn,
                                                  param_shardings,
                                                  placements, sp_rules,
                                                  spec_for)
    from repro_torch.launch.mesh import make_mesh
    out = {"acts": []}
    mesh = make_mesh((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)     # the same values on every rank
    for rules in (baseline_rules(), sp_rules()):
        shard = make_shard_fn(mesh, rules)
        for names, shape in [
                (("batch", "seq", None), (4, 6, 8)),
                (("batch", None, None), (3, 6, 8)),          # B % 2 != 0
                (("tokens", None, None), (8, 1, 8)),
                (("expert", "tokens", None, None), (4, 2, 3, 8)),
                ((None, "batch", None), (2, 4, 6)),
                ((None, None, "batch", None), (2, 3, 2, 6))]:
            x = torch.randn(shape, generator=g)
            d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
            y = shard(d, names)
            want = placements(mesh, spec_for(mesh, rules.acts, names, shape))
            out["acts"].append({
                "rules": rules.name, "names": names,
                "placements": tuple(y.placements) == want,
                "full": torch.equal(y.full_tensor(), x),
                "plain": shard(x, names) is x})
    # a dim over two axes: Shard(0) on both, pod outermost
    mesh2 = make_mesh((2, 2), ("pod", "data"))
    x = torch.arange(16.0).reshape(8, 2)
    y = make_shard_fn(mesh2, baseline_rules(multi_pod=True))(
        distribute_tensor(x, mesh2, [Replicate(), Replicate()]),
        ("batch", None))
    out["two_axes"] = (tuple(y.placements) == (Shard(0), Shard(0)),
                       torch.equal(y.to_local(), x[2 * rank:2 * rank + 2]),
                       torch.equal(y.full_tensor(), x))
    # a parameter placed by its rule
    spec = {"w": ParamSpec((8, 12), ("embed", "mlp"))}
    m, pls = param_shardings(mesh, baseline_rules(), spec)["w"]
    w = torch.randn(8, 12, generator=g)
    dw = distribute_tensor(w, m, pls)
    out["param"] = (tuple(pls) == (Shard(0), Shard(1)),
                    tuple(dw.to_local().shape) == (4, 6),
                    torch.equal(dw.full_tensor(), w))
    try:
        make_mesh((4, 2), ("data", "model"))
        out["too_few"] = False
    except ValueError:
        out["too_few"] = True
    return out


def decode_world(rank: int, cases: list, lm_cases: list) -> dict:
    """tests/test_torch_decode_distributed.py: each case's
    ``decode_attention_distributed`` on DTensor caches over its mesh (every
    rank builds every mesh; the ranks in it compute), then each LM case's
    ``decode_step(attn_dist=...)`` on a (1, 2) mesh against the
    undistributed step."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.arch.params import PartitionSpec as P
    from repro_torch.distributed.sharding import placements
    from repro_torch.kernels.decode_attention.distributed import (
        decode_attention_distributed)
    from repro_torch.launch.mesh import make_mesh
    out = {}
    meshes = {shape: make_mesh(shape, ("data", "model"))
              for shape in sorted({c["mesh"] for c in cases}
                                  | {(1, 2)})}
    for c in cases:
        mesh = meshes[c["mesh"]]
        if mesh.get_coordinate() is None:
            continue
        dt = getattr(torch, c["dtype"])
        q, k, v = (torch.from_numpy(c[n]).to(dt) for n in ("q", "k", "v"))
        lengths = torch.from_numpy(c["lengths"])
        bspec = "data" if q.shape[0] % c["mesh"][0] == 0 else None
        pl = placements(mesh, P(bspec, "model", None, None))
        got = decode_attention_distributed(
            q, distribute_tensor(k, mesh, pl), distribute_tensor(v, mesh, pl),
            lengths, mesh=mesh)
        out[c["label"]] = {"out": got.full_tensor().float(),
                           "placements": tuple(map(str, got.placements)),
                           "local_rows": got.to_local().shape[0]}
    mesh = meshes[(1, 2)]
    if mesh.get_coordinate() is not None:
        for lc in lm_cases:
            out[lc["arch"]] = _lm_decode(mesh, **lc)
    return out


def _lm_decode(mesh, arch: str, lengths, seed: int, S: int) -> dict:
    """One f32 decode step of ``arch`` with its k/v caches split in two along
    S, against the step on the whole caches; returns both logits, this
    rank's updated cache chunks and the whole updated caches."""
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_map
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    B = len(lengths)
    state = M.init_decode_state(cfg, B, S, device="cpu")
    state["caches"] = tree_map(
        lambda t: torch.randn(t.shape, generator=g, dtype=t.dtype), state["caches"])
    state["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    i, n = mesh.get_local_rank("model"), mesh.shape[1]
    S_loc = S // n

    def chunk(path_leaf, t):
        return t[:, :, i * S_loc:(i + 1) * S_loc].clone() \
            if path_leaf in ("k", "v") else t.clone()

    local = {"caches": {key: {name: chunk(name, t) for name, t in c.items()}
                        for key, c in state["caches"].items()},
             "lengths": state["lengths"].clone()}
    with torch.no_grad():
        want, whole = M.decode_step(cfg, params, state, {"tokens": tokens})
        got, mine = M.decode_step(cfg, params, local, {"tokens": tokens},
                                  attn_dist={"mesh": mesh})
    return {"logits": got, "want": want,
            "chunks": {k: {n: t for n, t in c.items() if n in ("k", "v")}
                       for k, c in mine["caches"].items()},
            "whole": {k: {n: t for n, t in c.items() if n in ("k", "v")}
                      for k, c in whole["caches"].items()},
            "lengths": mine["lengths"]}


# ------------------------------------------ training across devices

def _whole_np(tree):
    """Every leaf gathered whole (a collective over its mesh), as numpy."""
    from repro_torch.distributed.checkpoint import tree_map
    from repro_torch.distributed.sharding import gather_whole
    return tree_map(lambda t: gather_whole(t).numpy(), tree)


def _placed_train_state(cfg, np_params, mesh, rules):
    """The params (from numpy) and a zero AdamW state, at the cell's
    placements: params and moments at ``param_shardings``, the step count
    replicated."""
    from torch.distributed.tensor import Replicate

    from repro_torch.arch import model as M
    from repro_torch.arch.params import params_from_numpy
    from repro_torch.distributed.sharding import param_shardings, place_tree
    from repro_torch.train.optim import AdamWState, init_state
    params = params_from_numpy(np_params, "cpu")
    p_sh = param_shardings(mesh, rules, M.build_param_specs(cfg))
    o_sh = AdamWState((mesh, (Replicate(),) * mesh.ndim), p_sh, p_sh)
    return (*place_tree((params, init_state(params)), (p_sh, o_sh)), p_sh)


def _train_case(mesh, c: dict) -> dict:
    """``c["steps"]`` of a train cell's ``fn`` from ``c["params"]`` on the
    batches ``c["batches"]`` (numpy, placed at the cell's batch
    shardings): each step's metrics, then the params, moments and step
    count gathered whole, and whether every leaf kept its placements."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.compression import FeedbackHook
    from repro_torch.distributed.sharding import gather_whole, place
    from repro_torch.launch.cells import build_cell, cell_shardings
    cfg = get_config(c["arch"]).replace(dtype="float32")
    rules = getattr(S, c["rules"])("pod" in mesh.mesh_dim_names)
    B, seq = c["batches"][0]["labels"].shape
    cell = build_cell(cfg, ShapeSpec("t", seq, B, "train"), mesh,
                      rules=rules, microbatches=c["microbatches"],
                      grad_hook=FeedbackHook() if c["hook"] else None)
    params, ostate, p_sh = _placed_train_state(cfg, c["params"], mesh, rules)
    b_sh = cell_shardings(cell)[2]
    metrics = []
    for b in c["batches"]:
        batch = {k: place(torch.from_numpy(v), *b_sh[k]) for k, v in b.items()}
        params, ostate, m = cell.fn(params, ostate, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    kept = all(tuple(x.placements) == tuple(sh[1])
               for x, sh in zip(_leaves(params), _leaves(p_sh)))
    return {"metrics": metrics, "params": _whole_np(params),
            "mu": _whole_np(ostate.mu), "nu": _whole_np(ostate.nu),
            "step": int(gather_whole(ostate.step)), "placements_kept": kept,
            "microbatches": cell.microbatches}


def _leaves(tree) -> list:
    """A dict tree's leaves in sorted-key order (a ``(mesh, placements)``
    pair is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _serve_case(mesh, c: dict) -> dict:
    """A prefill cell and a decode cell of ``c["arch"]`` (f32) on
    ``mesh``: their outputs gathered whole."""
    from repro_torch.arch.params import tree_map
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.sharding import (gather_whole, place,
                                                  place_tree)
    from repro_torch.launch.cells import build_cell, cell_shardings
    cfg = get_config(c["arch"]).replace(dtype="float32")
    rules = getattr(S, c["rules"])(False)
    params = _placed_train_state(cfg, c["params"], mesh, rules)[0]
    tokens = torch.from_numpy(c["tokens"])
    B, seq = tokens.shape
    pre = build_cell(cfg, ShapeSpec("p", seq, B, "prefill"), mesh,
                     rules=rules)
    b_sh = cell_shardings(pre)[1]
    logits, state = pre.fn(params, {"tokens": place(tokens, *b_sh["tokens"])})
    out = {"prefill_logits": gather_whole(logits).numpy(),
           "prefill_state": _whole_np(state)}
    dec = build_cell(cfg, ShapeSpec("d", c["cache"], B, "decode"), mesh,
                     rules=rules, dist_decode=c["dist_decode"])
    _, s_sh, b_sh = cell_shardings(dec)
    dstate = tree_map(torch.from_numpy, c["state"])
    dstate = {"caches": place_tree(dstate["caches"], s_sh["caches"]),
              "lengths": place(dstate["lengths"], *s_sh["lengths"])}
    nxt = place(torch.from_numpy(c["next"]), *b_sh["tokens"])
    for _ in range(c["steps"]):
        logits, dstate = dec.fn(params, dstate, {"tokens": nxt})
    out["decode_logits"] = gather_whole(logits).numpy()
    out["decode_state"] = _whole_np(dstate)
    out["state_placements_kept"] = all(
        tuple(x.placements) == tuple(sh[1]) for x, sh in
        zip(_leaves(dstate["caches"]), _leaves(s_sh["caches"])))
    return out


def sharded_train_world(rank: int, train_cases: list,
                        serve_cases: list) -> list:
    """tests/test_torch_sharded_train.py: each train case's cell steps on
    its mesh, then each serve case's prefill and decode cells; rank 0
    returns the results."""
    from repro_torch.launch.mesh import make_mesh
    meshes, out = {}, {"train": [], "serve": []}
    for kind, cases, run in (("train", train_cases, _train_case),
                             ("serve", serve_cases, _serve_case)):
        for c in cases:
            key = (tuple(c["mesh"]), tuple(c["axes"]))
            if key not in meshes:
                meshes[key] = make_mesh(*key)
            res = run(meshes[key], c)
            out[kind].append(res if rank == 0 else None)
    return out


def elastic_world(rank: int, arch: str, np_params, batches, ckpt: str,
                  survivors: list) -> dict:
    """tests/test_torch_elastic.py: one train-cell step of ``arch`` (f32)
    on a (2, 2) mesh, the state saved sharded; the rank after the
    survivors "lost"; ``elastic_remesh(survivors, model_axis=2)`` (every
    rank calls it); the checkpoint restored onto the new mesh at its
    ``param_shardings`` and one more step there."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.arch import model as M
    from repro_torch.arch.params import shape_structs
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.checkpoint import flatten, restore, save
    from repro_torch.distributed.fault import elastic_remesh
    from repro_torch.distributed.sharding import (baseline_rules,
                                                  param_shardings, place)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optim import AdamWState
    cfg = get_config(arch).replace(dtype="float32")
    rules = baseline_rules()
    B, seq = batches[0]["labels"].shape
    shape = ShapeSpec("t", seq, B, "train")
    mesh = make_mesh((2, 2), ("data", "model"))
    params, ostate, _ = _placed_train_state(cfg, np_params, mesh, rules)
    cell = build_cell(cfg, shape, mesh, rules=rules, microbatches=1)
    b_sh = cell_shardings(cell)[2]
    params, ostate, _ = cell.fn(params, ostate, {
        k: place(torch.from_numpy(v), *b_sh[k]) for k, v in
        batches[0].items()})
    state = {"params": params, "opt": ostate}
    save(ckpt, state, step=5)
    out = {"saved": _whole_np(state)}
    new = elastic_remesh(survivors, model_axis=2)
    out["mesh_shape"] = tuple(new.shape)
    out["mesh_ranks"] = new.mesh.tolist()
    if new.get_coordinate() is None:
        return out
    specs = M.build_param_specs(cfg)
    p_sh = param_shardings(new, rules, specs)
    like = {"params": shape_structs(specs, torch.float32),
            "opt": AdamWState(torch.empty((), dtype=torch.int32,
                                          device="meta"),
                              shape_structs(specs, torch.float32),
                              shape_structs(specs, torch.float32))}
    sh = {"params": p_sh,
          "opt": AdamWState((new, (Replicate(),) * new.ndim), p_sh, p_sh)}
    restored, manifest = restore(ckpt, like, shardings=sh)
    out["manifest"] = manifest
    out["on_new_mesh"] = all(isinstance(x, DTensor) and x.device_mesh == new
                             for x in flatten(restored))
    out["restored"] = _whole_np(restored)
    cell2 = build_cell(cfg, shape, new, rules=rules, microbatches=1)
    b_sh = cell_shardings(cell2)[2]
    p, o, m = cell2.fn(restored["params"], restored["opt"], {
        k: place(torch.from_numpy(v), *b_sh[k]) for k, v in
        batches[1].items()})
    out["next"] = {"params": _whole_np(p), "mu": _whole_np(o.mu),
                   "metrics": {k: float(v) for k, v in m.items()}}
    return out


def failed_write_world(rank: int, root: str, failing: int) -> dict:
    """tests/test_torch_elastic.py: sharded saves of a (2, 2) mesh whose
    shard write fails on rank ``failing`` (its ``np.savez`` raises, as on
    a full disk), by ``CheckpointManager.save_async`` + ``wait`` and by
    ``save``: what each rank raised, then the latest checkpoint restored
    whole."""
    import numpy as np
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import checkpoint as C
    from repro_torch.distributed.sharding import gather_whole, place
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    pls = (Shard(0), Shard(1))
    tree = {"w": torch.arange(32.0).reshape(4, 8)}
    placed = {"w": place(tree["w"], mesh, pls)}
    mgr = C.CheckpointManager(root, keep=3)
    mgr.save_async(placed, step=1)
    mgr.wait()
    savez = np.savez

    def full_disk(*args, **kw):
        raise OSError(28, "No space left on device")

    def save_async():
        mgr.save_async(placed, step=2)
        mgr.wait()
    out = {}
    for name, save in (("save_async", save_async),
                       ("save", lambda: C.save(f"{root}/step-3", placed,
                                               step=3))):
        if rank == failing:
            np.savez = full_disk
        try:
            save()
            out[name] = None
        except Exception as e:          # noqa: BLE001  (what each raised)
            out[name] = type(e).__name__
        finally:
            np.savez = savez
    restored, manifest = mgr.restore_latest(tree, shardings={"w": (mesh,
                                                                   pls)})
    out["latest"] = manifest["step"]
    out["restored"] = gather_whole(restored["w"]).numpy()
    return out


# ------------------------------------------ tensor-parallel cells

#: ``torch.distributed`` collectives the cells may issue, recorded by the
#: tensor-parallel world's patch; each entry's wire bytes as a device
#: receives them in a ring (``launch.dryrun._ring``'s model)
_RECORDED = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
             "reduce_scatter_single", "reduce_scatter_tensor", "all_gather",
             "reduce_scatter", "broadcast", "all_to_all_single",
             "all_to_all")
#: DTensor's own collectives (``_functional_collectives``): a cell that
#: reached one would move data the count does not see
_FUNCTIONAL = ("all_gather_single", "all_gather_tensor", "all_reduce",
               "reduce_scatter_single", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")


class CollectiveLog:
    """A test-only patch of ``torch.distributed``'s collectives (and of
    DTensor's functional ones) that records, while ``on``, each call's
    kind, group, input shape and ring wire bytes, then issues it."""

    def __init__(self):
        import torch.distributed._functional_collectives as funcol
        self.calls, self.on = [], False
        self._saved = []
        for mod, names, tag in ((dist, _RECORDED, ""),
                                (funcol, _FUNCTIONAL, "functional:")):
            for name in names:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(tag + name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if self.on:
                self.calls.append(self._entry(name, args, kw))
            return fn(*args, **kw)
        return call

    @staticmethod
    def _entry(name, args, kw) -> dict:
        group = kw.get("group")
        n = 0 if name.startswith("functional") \
            else dist.get_world_size(group)
        if name == "all_reduce":
            t = args[0]
            nbytes = t.numel() * t.element_size()
            kind, wire = "all-reduce", 2 * (n - 1) / n * nbytes
        elif name in ("all_gather_single", "all_gather_into_tensor"):
            t = args[1]
            nbytes = t.numel() * t.element_size()
            kind, wire = "all-gather", (n - 1) * nbytes
        elif name in ("reduce_scatter_single", "reduce_scatter_tensor"):
            t = args[1]
            nbytes = t.numel() * t.element_size()
            kind, wire = "reduce-scatter", (n - 1) / n * nbytes
        elif name == "all_to_all_single":
            # the bytes this rank receives from the others
            out, t = args[0], args[1]
            split = args[2] if len(args) > 2 else kw.get("output_split_sizes")
            row = out[:1].numel() * out.element_size()
            own = split[dist.get_rank(group)] if split else out.shape[0] // n
            kind, wire = "all-to-all", (out.shape[0] - own) * row
        else:
            t = args[0] if args and isinstance(args[0], torch.Tensor) \
                else None
            kind, wire = name, 0.0
        return {"kind": kind, "wire": wire, "group": group, "n": n,
                "shape": tuple(t.shape) if t is not None else None}

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _tally(calls) -> dict:
    """{kind: [count, wire bytes]} of recorded calls."""
    out = {}
    for c in calls:
        t = out.setdefault(c["kind"], [0, 0.0])
        t[0] += 1
        t[1] += c["wire"]
    return out


def _attn_shapes(params) -> set:
    """Every shape an ``attn``-kind leaf (an attention block's attention
    and MLP leaves, the embedding, the LM head) takes on a rank before a
    gather over ``model``: its block and a period's slice of it. No
    all-gather over ``model`` may carry one outside the guard."""
    out = set()

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        if path[0] == "blocks" and path[2] not in ("attn", "mlp"):
            return
        if path[0] not in ("blocks", "embed", "lm_head"):
            return
        local = tuple(tree.to_local().shape)
        out.update({local, local[1:] if path[0] == "blocks" else local})
    walk(params, ())
    return out


def _expert_shapes(params) -> set:
    """Every shape an expert weight (``w_gate``, ``w_up``, ``w_down`` of a
    MoE block, not its shared expert) takes on a rank before a gather over
    ``model``: its block and a period's slice of it."""
    out = set()
    for period in params["blocks"].values():
        moe = period.get("moe")
        if moe is None:
            continue
        for name in ("w_gate", "w_up", "w_down"):
            local = tuple(moe[name].to_local().shape)
            out.update({local, local[1:]})
    return out


def _mamba_shapes(params) -> dict:
    """{shape: leaf name} of every Mamba2 mixer weight but ``conv_w`` and
    ``conv_b`` (gathered over ``model`` once a call in every cell) on a
    rank before a gather over ``model``: its block and a period's slice
    of it."""
    out = {}
    for period in params["blocks"].values():
        mixer = period.get("mixer")
        if mixer is None:
            continue
        for name, leaf in mixer.items():
            if name in ("conv_w", "conv_b"):
                continue
            local = tuple(leaf.to_local().shape)
            out.update({local: name, local[1:]: name})
    return out


def _rwkv_shapes(params) -> dict:
    """{shape: the RWKV6 leaves of that shape, as ``"tm.wr/tm.wk"``} of
    every RWKV6 weight (time-mix and channel-mix) on a rank before a
    gather over ``model``: its block and a period's slice of it."""
    names = {}
    for period in params["blocks"].values():
        for part in ("tm", "cm"):
            for name, leaf in period.get(part, {}).items():
                local = tuple(leaf.to_local().shape)
                for shape in (local, local[1:]):
                    names.setdefault(shape, set()).add(f"{part}.{name}")
    return {shape: "/".join(sorted(n)) for shape, n in names.items()}


def _watched(c, params):
    """The leaf shapes whose all-gathers over ``model`` are recorded: the
    experts' (``c["watch"] == "experts"``), the Mamba2 mixers' (``"mamba"``,
    a dict naming each shape's leaf), the RWKV6 mixes' (``"rwkv"``, the
    same) or the ``attn``-kind leaves'."""
    return {"experts": _expert_shapes, "mamba": _mamba_shapes,
            "rwkv": _rwkv_shapes}.get(c.get("watch"), _attn_shapes)(params)


def _model_gathers(calls, mesh, shapes) -> list:
    """The recorded all-gathers over ``mesh``'s model group whose input
    has the shape of a watched leaf (its name where ``shapes`` names
    them)."""
    group = mesh.get_group("model") if mesh.shape[
        mesh.mesh_dim_names.index("model")] > 1 else None
    return [shapes[c["shape"]] if isinstance(shapes, dict) else c["shape"]
            for c in calls if c["kind"] == "all-gather"
            and group is not None and c["group"] is group
            and c["shape"] in shapes]


def _model_rank(mesh) -> int:
    """This rank's coordinate on ``mesh``'s model axis."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]


def _count(cell) -> dict:
    """``dryrun.account``'s collectives for ``cell`` on this rank (its
    all-to-all wire is its model coordinate's): {kind: [count, wire
    bytes]}."""
    from repro_torch.launch.dryrun import account
    c = account(cell, _model_rank(cell.mesh))["count"]
    return {k: [c.collective_counts[k], c.collectives[k]]
            for k in c.collectives}


def _tp_cfg(c):
    from repro_torch.configs import get_config
    cfg = get_config(c["arch"]).replace(dtype="float32")
    return cfg.replace(**c.get("cfg", {}))


def _tp_train(mesh, c: dict, log: CollectiveLog) -> dict:
    """A train cell's steps, each from the state ``c["starts"]`` gives it
    (numpy params, moments and step count, placed at the cell's
    placements) on its batch: each step's metrics, state gathered whole,
    collectives, and whether every leaf kept its placements."""
    from torch.distributed.tensor import Replicate

    from repro_torch.arch import model as M
    from repro_torch.arch.params import params_from_numpy
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.sharding import (gather_whole,
                                                  param_shardings, place,
                                                  place_tree)
    from repro_torch.launch.cells import build_cell, cell_shardings
    from repro_torch.train.optim import AdamWState
    cfg = _tp_cfg(c)
    rules = getattr(S, c["rules"])("pod" in mesh.mesh_dim_names)
    B, seq = c["batches"][0]["labels"].shape
    cell = build_cell(cfg, ShapeSpec("t", seq, B, "train"), mesh,
                      rules=rules, microbatches=c["microbatches"])
    undo = _plant(c.get("fault"))
    p_sh = param_shardings(mesh, rules, M.build_param_specs(cfg))
    o_sh = AdamWState((mesh, (Replicate(),) * mesh.ndim), p_sh, p_sh)
    b_sh = cell_shardings(cell)[2]
    steps = []
    for start, b in zip(c["starts"], c["batches"]):
        params, ostate = place_tree((
            params_from_numpy(start["params"], "cpu"),
            AdamWState(torch.tensor(start["step"], dtype=torch.int32),
                       params_from_numpy(start["mu"], "cpu"),
                       params_from_numpy(start["nu"], "cpu"))), (p_sh, o_sh))
        shapes = _watched(c, params)
        batch = {k: place(torch.from_numpy(v), *b_sh[k]) for k, v in b.items()}
        log.on = True
        params, ostate, m = cell.fn(params, ostate, batch)
        log.on = False
        calls = log.take()
        steps.append({
            "tally": _tally(calls),
            "model_gathers": _model_gathers(calls, mesh, shapes),
            "metrics": {k: float(v) for k, v in m.items()},
            "params": _whole_np(params), "mu": _whole_np(ostate.mu),
            "nu": _whole_np(ostate.nu), "step": int(gather_whole(ostate.step)),
            "placements_kept": all(
                tuple(x.placements) == tuple(sh[1])
                for x, sh in zip(_leaves(params), _leaves(p_sh)))})
    undo()
    return {"steps": steps, "account": _count(cell), "guarded": cell.guarded,
            "mamba_split": cell.mamba_split, "rwkv_split": cell.rwkv_split,
            "in_proj_route": cell.in_proj_route}


def _model_sum_set(leaf_plans, which, value: bool):
    """``leaf_plans`` with ``model_sum`` set to ``value`` on the plans
    ``which(path)`` picks."""
    import dataclasses
    import functools

    @functools.wraps(leaf_plans)
    def plans(*args, **kw):
        return [dataclasses.replace(p, model_sum=value)
                if which(p.path) else p for p in leaf_plans(*args, **kw)]
    return plans


def _gate_identity_backward(tp, r, kv):
    """``TPContext.gate`` with ``kv``'s sum taken by an all-reduce whose
    backward is the identity, then cut to this rank's columns: the same
    forward, but each rank's partial ``kv`` gets only its own columns'
    gradient (it needs every column's)."""
    from repro_torch.distributed.sharding import gather_out, reduce_out
    dim = kv.ndim - 1
    k = kv.shape[dim] // tp.tp
    own = reduce_out(kv, tp.model, tp.tp).narrow(dim, tp.rank * k, k)
    return gather_out(r * own, dim, tp.model, tp.tp, tp.rank)


def _slot_offset_floor(own):
    """``layers.head_range`` with a split slot's first head at ``rank x
    floor(H / tp)`` instead of ``rank x ceil(H / tp)``: the same heads a
    rank, the wrong KV heads read for them where ``tp`` does not divide
    H."""
    def head_range(cfg, p, tp):
        lo, n = own(cfg, p, tp)
        if n != cfg.num_heads:
            lo = tp.rank * (cfg.num_heads // tp.tp)
        return lo, n
    return head_range


def _to_cols_summing_backward(own):
    """``TPContext.to_cols`` whose backward sums the incoming gradient of
    the rank's column block over ``model`` before sending it back (as if
    every rank held a partial of every column): the same forward, but each
    rank's block gets the others' gradients added where it should keep its
    own."""
    from repro_torch.distributed.sharding import copy_in

    def to_cols(tp, y, heads, unit):
        return copy_in(own(tp, y, heads, unit), tp.model, tp.tp)
    return to_cols


#: planted faults a train case may carry, each (what it patches: the leaf
#: plans, a ``TPContext`` method or an ``arch.layers`` function
#: (``"layers.<name>"``), the patch): the router's gradient
#: summed over ``model``; a split mixer's norm sum with an identity
#: backward; ``conv_w``'s and the shared block's ``wk``'s gradients left
#: unsummed over ``model``; a split RWKV6 time-mix's ``lora_A`` (the
#: lerp) and ``ln_x_scale`` (the group norm) left unsummed; the
#: channel-mix's gate combine with an identity backward; a split
#: attention's slot offset by floor(H / tp), its ``wk`` gradient left
#: unsummed over ``model``, and its exchange back to the column blocks
#: summing the gradient in its backward
_FAULTS = {
    "router_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path[-1] == "router", True)),
    "conv_w_no_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path[-2:] == ("mixer", "conv_w"), False)),
    "shared_wk_no_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path == ("shared", "attn", "wk"), False)),
    "norm_sum_identity_backward": ("total", lambda own: own.reduce),
    "lerp_no_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path[-2:] == ("tm", "lora_A"), False)),
    "ln_x_scale_no_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path[-2:] == ("tm", "ln_x_scale"), False)),
    "gate_combine_identity_backward": ("gate",
                                       lambda own: _gate_identity_backward),
    "slot_offset_floor": ("layers.head_range", _slot_offset_floor),
    "attn_wk_no_model_sum": ("plans", lambda lp: _model_sum_set(
        lp, lambda path: path[-2:] == ("attn", "wk"), False)),
    "slot_exchange_summing_backward": (
        "to_cols", lambda own: _to_cols_summing_backward(own.to_cols)),
}


def _plant(fault):
    """Plant ``fault`` (a ``_FAULTS`` key, or None); returns its undo."""
    from repro_torch.arch import layers
    from repro_torch.distributed.sharding import TPContext
    from repro_torch.launch import cells
    if fault is None:
        return lambda: None
    what, patch = _FAULTS[fault]
    if what == "plans":
        own = cells.leaf_plans
        cells.leaf_plans = patch(own)
        return lambda: setattr(cells, "leaf_plans", own)
    if what.startswith("layers."):
        name = what.split(".", 1)[1]
        own = getattr(layers, name)
        setattr(layers, name, patch(own))
        return lambda: setattr(layers, name, own)
    own = getattr(TPContext, what)
    setattr(TPContext, what, patch(TPContext))
    return lambda: setattr(TPContext, what, own)


def _tp_serve(mesh, c: dict, log: CollectiveLog) -> dict:
    """A prefill cell and a decode cell (with or without the distributed
    flash-decode) under ``c["rules"]``: their outputs gathered whole and
    each call's collectives against ``dryrun.account``."""
    from repro_torch.arch.params import tree_map
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.sharding import (gather_whole, place,
                                                  place_tree)
    from repro_torch.launch.cells import build_cell, cell_shardings
    cfg = _tp_cfg(c)
    rules = getattr(S, c["rules"])(False)
    params = _placed_train_state(cfg, c["params"], mesh, rules)[0]
    shapes = _watched(c, params)
    inputs = {k: torch.from_numpy(v) for k, v in c["inputs"].items()}
    first = inputs["tokens" if "tokens" in inputs else "frames"]
    B, seq = first.shape[:2]
    pre = build_cell(cfg, ShapeSpec("p", seq, B, "prefill"), mesh,
                     rules=rules, serve_dtype="float32")
    b_sh = cell_shardings(pre)[1]
    log.on = True
    logits, state = pre.fn(params, {k: place(v, *b_sh[k])
                                    for k, v in inputs.items()})
    log.on = False
    calls = log.take()
    out = {"prefill_logits": gather_whole(logits).numpy(),
           "prefill_placements": tuple(map(str, logits.placements)),
           "prefill_state": _whole_np(state),
           "prefill": {"tally": _tally(calls), "account": _count(pre),
                       "model_gathers": _model_gathers(calls, mesh, shapes)},
           "guarded": pre.guarded, "mamba_split": pre.mamba_split,
           "rwkv_split": pre.rwkv_split,
           "in_proj_route": {"prefill": pre.in_proj_route}}
    if "state" not in c:
        return out
    out["decode"] = {}
    for dist_decode in (False, True):
        dec = build_cell(cfg, ShapeSpec("d", c["cache"], B, "decode"), mesh,
                         rules=rules, dist_decode=dist_decode,
                         serve_dtype="float32")
        _, s_sh, b_sh = cell_shardings(dec)
        # a copy each call: the cell writes the state's blocks in place
        dstate = tree_map(lambda a: torch.from_numpy(a.copy()), c["state"])
        dstate = {"caches": place_tree(dstate["caches"], s_sh["caches"]),
                  "lengths": place(dstate["lengths"], *s_sh["lengths"])}
        nxt = place(torch.from_numpy(c["next"]), *b_sh["tokens"])
        log.on = True
        logits, dstate = dec.fn(params, dstate, {"tokens": nxt})
        log.on = False
        calls = log.take()
        out["decode"][dist_decode] = {
            "logits": gather_whole(logits).numpy(), "state": _whole_np(dstate),
            "tally": _tally(calls), "account": _count(dec),
            "model_gathers": _model_gathers(calls, mesh, shapes),
            "in_proj_route": dec.in_proj_route,
            "placements_kept": all(
                tuple(x.placements) == tuple(sh[1]) for x, sh in
                zip(_leaves(dstate["caches"]), _leaves(s_sh["caches"])))}
    return out


def tensor_parallel_world(rank: int, train_cases: list,
                          serve_cases: list) -> dict:
    """tests/test_torch_tensor_parallel.py,
    tests/test_torch_mamba_parallel.py and
    tests/test_torch_rwkv_parallel.py: each train case's cell steps (a
    planted fault where the case names one) and each serve case's prefill
    and decode cells on their meshes, every call's collectives recorded
    (by every rank)."""
    from repro_torch.launch.mesh import make_mesh
    log = CollectiveLog()
    meshes, out = {}, {"train": [], "serve": []}
    try:
        for kind, cases, run in (("train", train_cases, _tp_train),
                                 ("serve", serve_cases, _tp_serve)):
            for c in cases:
                key = tuple(c["mesh"])
                if key not in meshes:
                    meshes[key] = make_mesh(key, ("data", "model"))
                out[kind].append(run(meshes[key], c, log))
    finally:
        log.close()
    return out


def _ep_block(mesh, c: dict) -> dict:
    """One MoE block (``moe_block_dispatch`` at capacity factor
    ``c["cf"]``, or ``moe_block_dense`` where ``c["path"]`` says so) on
    this rank's expert shards of ``c["params"]`` over
    ``mesh``'s model axis, every rank on the same ``c["x"]``: its output,
    aux losses, the gradients of ``x`` and of the router and expert leaves
    (this rank's shards) for the output gradient ``c["dy"]``, and the
    dispatch's slots and capacity (every call's, recorded)."""
    from repro_torch.arch import moe
    from repro_torch.distributed.sharding import TPContext
    cfg = _tp_cfg(c)
    n = mesh.shape[mesh.mesh_dim_names.index("model")]
    r = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]
    E = cfg.num_experts
    p = {k: torch.from_numpy(v) for k, v in c["params"].items()}
    if E % n == 0:                             # expert@model
        el = E // n
        p = {k: v[r * el:(r + 1) * el] if k != "router" else v
             for k, v in p.items()}
    else:                                      # expert_mlp@model
        f = cfg.d_ff // n
        p = {"router": p["router"],
             "w_gate": p["w_gate"][..., r * f:(r + 1) * f],
             "w_up": p["w_up"][..., r * f:(r + 1) * f],
             "w_down": p["w_down"][:, r * f:(r + 1) * f]}
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    tp = TPContext(model=mesh.get_group("model"), tp=n, rank=r)
    slots, own = [], moe.dispatch_slots

    def recorded(ig, E):
        slots.append(own(ig, E))
        return slots[-1]
    moe.dispatch_slots = recorded
    try:
        if c["path"] == "dense":
            out, aux = moe.moe_block_dense(cfg, p, x, tp=tp)
        else:
            out, aux = moe.moe_block_dispatch(
                cfg, p, x, capacity_factor=c["cf"], groups=c["groups"],
                tp=tp)
    finally:
        moe.dispatch_slots = own
    loss = torch.sum(out * torch.from_numpy(c["dy"])) \
        + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    loss.backward()
    G, Sg, C = moe.dispatch_geometry(cfg, x.shape[0] * x.shape[1], c["cf"],
                                     c["groups"])
    return {"out": out.detach().numpy(),
            "aux": {k: float(v) for k, v in aux.items()},
            "dx": x.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in p.items()},
            "slots": [t.numpy() for t in slots], "capacity": C,
            "rank": r, "n": n}


def expert_parallel_world(rank: int, train_cases: list, serve_cases: list,
                          block_cases: list) -> dict:
    """tests/test_torch_expert_parallel.py: the MoE configs' train and
    serve cells (as ``tensor_parallel_world``'s, their expert weights
    watched), then single MoE blocks on their expert shards."""
    from repro_torch.launch.mesh import make_mesh
    out = tensor_parallel_world(rank, train_cases, serve_cases)
    out["blocks"] = []
    for c in block_cases:
        mesh = make_mesh(tuple(c["mesh"]), ("data", "model"))
        out["blocks"].append(_ep_block(mesh, c))
    return out
