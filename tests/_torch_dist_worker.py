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
