"""Sharded, asynchronous, atomic, elastic checkpointing of a tensor tree.

The on-disk format is the JAX package's (``repro.distributed.checkpoint``),
so a checkpoint of plain tensors written by either package restores into
the other:

  * ``shard-0.npz`` holds the leaves as ``a0 .. an`` in the reference's
    flatten order: dict keys sorted, ``NamedTuple`` fields in order (the
    AdamW state), tuples and lists in order, ``None`` no leaf;
  * ``manifest.json`` records the step, the leaf count, a description of
    the tree, the process count (1: one process, one card) and ``extra``.
  * SHARDED: a tree with DTensor leaves (on one ``DeviceMesh``) is written
    by every rank of the mesh, each into ``shard-<rank>.npz``: its local
    shard ``a<i>`` of each leaf it holds at coordinate 0 of every mesh dim
    the leaf is replicated on, so each element is written once. The
    manifest's ``process_count`` is the world size, and its ``leaves``
    give per leaf the global shape and dtype and the mesh (ranks, dim
    names) and placements it was saved from (for a plain leaf of such a
    tree, the rank that wrote it).
  * ELASTIC: ``restore`` assembles each leaf from the shard files and
    places it on the ``(mesh, placements)`` it is given, which may be
    another, smaller mesh than the one saved from.
  * ASYNC: ``save_async`` copies the tensors (a DTensor's local shard) to
    host memory synchronously and writes on a background thread, at most
    one write pending; a sharded save is completed (manifest, rename) in
    ``wait``, by the mesh's ranks together, since only the thread that
    issues a process's collectives may wait for the others.
  * ATOMIC: writes go to ``<dir>.tmp``, then a rename; a crash mid-save
    never corrupts the latest complete checkpoint.

A leaf restores with the dtype (and, unplaced, the device) of the tree it
restores into. bf16 tensors are written as f32 (numpy has no bf16) and
cast back.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .sharding import contiguous_stride


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> list:
    """Leaves in the reference's pytree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten(t)]
    if tree is None:
        return []
    return [tree]


def tree_map(f, tree):
    """``f`` on every leaf of a tree of dicts, tuples, lists, NamedTuples,
    called in ``flatten``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(f, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, t) for t in tree)
    if tree is None:
        return None
    return f(tree)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{n}={_describe(t)}" for n, t in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(t) for t in tree) + ")"
    return "None" if tree is None else "*"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf: a snapshot, which later in-place writes to a
    tensor (of the CPU too, whose ``numpy()`` would share its memory) do
    not reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(path: str, tree, *, step: int, extra: Optional[dict] = None):
    """Synchronous save: one shard file for a tree of plain tensors, one a
    rank for a tree of DTensors (every rank of their mesh calls it)."""
    mesh = _tree_mesh(tree)
    if mesh is not None:
        write = _begin_sharded(Path(path), tree, mesh, step, extra)
        error = None
        try:
            write()
        except Exception as e:               # noqa: BLE001  (finish raises)
            error = e
        write.finish(error)
        return
    p = Path(path)
    tmp = Path(str(p) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = flatten(tree)
    np.savez(tmp / "shard-0.npz",
             **{f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})
    manifest = {
        "step": int(step),
        "n_leaves": len(leaves),
        "treedef": _describe(tree),
        "process_count": 1,
        "written_at": time.time(),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if p.exists():
        shutil.rmtree(p)
    tmp.rename(p)


# ------------------------------------------------------------ sharded trees

def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _tree_mesh(tree):
    """The one ``DeviceMesh`` of the tree's DTensor leaves, or None."""
    meshes = []
    for x in flatten(tree):
        if _is_dtensor(x) and x.device_mesh not in meshes:
            meshes.append(x.device_mesh)
    if len(meshes) > 1:
        raise ValueError(f"a checkpointed tree holds DTensors on "
                         f"{len(meshes)} meshes; one is supported")
    return meshes[0] if meshes else None


def _placement_names(placements) -> list:
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in placements:
        if isinstance(pl, Shard):
            out.append(f"S({pl.dim})")
        elif isinstance(pl, Replicate):
            out.append("R")
        else:
            raise ValueError(f"cannot checkpoint a {pl} placement: reduce "
                             "it first")
    return out


def _shard_dim(name: str) -> Optional[int]:
    return int(name[2:-1]) if name.startswith("S(") else None


def _block(shape, mesh_shape, placements, coord) -> tuple:
    """The slices of a global tensor of ``shape`` that the rank at
    ``coord`` holds under ``placements`` (``_placement_names``): the mesh
    dims split in order, the first outermost, evenly."""
    off, size = [0] * len(shape), list(shape)
    for i, name in enumerate(placements):
        d = _shard_dim(name)
        if d is None:
            continue
        n = mesh_shape[i]
        if size[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n} ranks")
        size[d] //= n
        off[d] += coord[i] * size[d]
    return tuple(slice(o, o + n) for o, n in zip(off, size))


def _writes(placements, coord) -> bool:
    """Each element once: the rank at coordinate 0 of every mesh dim the
    leaf is replicated on writes its block."""
    return all(c == 0 for c, name in zip(coord, placements)
               if _shard_dim(name) is None)


def _mesh_barrier(mesh) -> None:
    """No rank of ``mesh`` passes before all have reached it: a barrier
    over each mesh dim's group in turn."""
    import torch.distributed as dist
    kw = {"device_ids": [torch.cuda.current_device()]} \
        if mesh.device_type == "cuda" else {}
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d), **kw)


def _mesh_any(mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of ``mesh``; no rank returns
    before all have called it (a max over each mesh dim's group in
    turn)."""
    import torch.distributed as dist
    t = torch.tensor([float(flag)], device=_mesh_device(mesh))
    for d in range(mesh.ndim):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(d))
    return bool(t.item())


class _ShardedWrite:
    """One rank's part of a sharded save, begun (the tmp directory made,
    every rank past it) and snapshot to host: calling it writes the
    rank's shard file (on any thread); ``finish`` (every rank of the mesh,
    on the thread that issues its collectives, whether its write failed
    or not) completes the checkpoint, or raises on every rank if a
    rank's write failed."""

    def __init__(self, path: Path, arrays: dict, manifest: dict, mesh,
                 rank: int, lead: int):
        self.path, self.arrays, self.manifest = path, arrays, manifest
        self.mesh, self.rank, self.lead = mesh, rank, lead
        self.tmp = Path(str(path) + ".tmp")

    def __call__(self) -> None:
        np.savez(self.tmp / f"shard-{self.rank}.npz", **self.arrays)
        self.arrays = None

    def finish(self, error: Optional[BaseException] = None) -> None:
        """Complete the checkpoint; ``error``: this rank's write failed.
        The ranks agree first, so a failed write raises on every rank
        (its own error on the rank that failed) and none waits on it;
        the latest complete checkpoint stays in place."""
        self.arrays = None
        if _mesh_any(self.mesh, error is not None):   # every file written?
            if error is not None:
                raise error
            raise RuntimeError(f"checkpoint {self.path}: another rank's "
                               "shard write failed")
        if self.rank == self.lead:
            self.manifest["written_at"] = time.time()
            (self.tmp / "manifest.json").write_text(
                json.dumps(self.manifest, indent=1))
            if self.path.exists():
                shutil.rmtree(self.path)
            self.tmp.rename(self.path)
        _mesh_barrier(self.mesh)             # the checkpoint is in place


def _begin_sharded(path: Path, tree, mesh, step: int,
                   extra: Optional[dict]) -> _ShardedWrite:
    """Make ``<path>.tmp`` (the mesh's lowest rank), wait for the mesh's
    ranks, and snapshot this rank's blocks to host memory."""
    import torch.distributed as dist
    rank = dist.get_rank()
    lead = int(mesh.mesh.min())
    tmp = Path(str(path) + ".tmp")
    if rank == lead:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _mesh_barrier(mesh)
    arrays, metas = {}, []
    for i, leaf in enumerate(flatten(tree)):
        if _is_dtensor(leaf):
            names = _placement_names(leaf.placements)
            lm = leaf.device_mesh
            metas.append({"shape": list(leaf.shape),
                          "dtype": str(leaf.dtype).removeprefix("torch."),
                          "mesh": lm.mesh.tolist(),
                          "mesh_dim_names": list(lm.mesh_dim_names or ()),
                          "placements": names})
            if _writes(names, lm.get_coordinate()):
                arrays[f"a{i}"] = _to_numpy(leaf.to_local().contiguous())
        else:
            metas.append({"writer": lead})
            if rank == lead:
                arrays[f"a{i}"] = _to_numpy(leaf)
    manifest = {
        "step": int(step),
        "n_leaves": len(metas),
        "treedef": _describe(tree),
        "process_count": dist.get_world_size(),
        "written_at": None,
        "extra": extra or {},
        "leaves": metas,
    }
    return _ShardedWrite(path, arrays, manifest, mesh, rank, lead)


def _assemble(p: Path, i: int, meta: Optional[dict], files: dict):
    """Leaf ``i`` whole, as numpy, from the shard files that hold it."""
    def load(rank):
        if rank not in files:
            files[rank] = np.load(p / f"shard-{rank}.npz")
        return files[rank]
    if meta is None:                     # the one-file format
        return load(0)[f"a{i}"]
    if "placements" not in meta:
        return load(meta["writer"])[f"a{i}"]
    ranks = np.asarray(meta["mesh"])
    names = meta["placements"]
    writers = [c for c in np.ndindex(*ranks.shape) if _writes(names, c)]
    if len(writers) == 1:                # one block holds the whole leaf
        return load(int(ranks[writers[0]]))[f"a{i}"]
    out = None
    for coord in writers:
        block = load(int(ranks[coord]))[f"a{i}"]
        if out is None:
            out = np.empty(meta["shape"], dtype=block.dtype)
        out[_block(meta["shape"], ranks.shape, names, coord)] = block
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(arr: np.ndarray, like, sharding):
    """A whole leaf ``arr`` as the restored leaf: on ``sharding``
    (``(mesh, placements)``), else like ``like`` (a DTensor's mesh and
    placements, a tensor's device), in ``like``'s dtype."""
    if sharding is None and _is_dtensor(like):
        sharding = (like.device_mesh, like.placements)
    if not isinstance(like, torch.Tensor):
        return arr.astype(like.dtype) if hasattr(like, "dtype") else arr
    if sharding is None:
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    from torch.distributed.tensor import DTensor
    mesh, pls = sharding
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("restore onto a mesh this rank is not in")
    block = np.asarray(arr[_block(arr.shape, tuple(mesh.shape),
                                  _placement_names(pls), coord)])
    if not block.flags.c_contiguous:     # a strided view of a larger leaf
        block = np.ascontiguousarray(block)
    local = torch.from_numpy(block).to(
        device=_mesh_device(mesh), dtype=like.dtype)
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=contiguous_stride(arr.shape))


def _sharding_leaves(tree) -> list:
    """The ``(mesh, placements)`` leaves of a shardings tree, in
    ``flatten``'s order."""
    if isinstance(tree, tuple) and len(tree) == 2 \
            and hasattr(tree[0], "mesh_dim_names"):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _sharding_leaves(t)]
    return []


def restore(path: str, like_tree, *, shardings=None):
    """Restore into the structure of ``like_tree``: each leaf assembled
    whole in the dtype of its counterpart there, then placed on its leaf
    of ``shardings`` (a ``(mesh, placements)`` tree mirroring
    ``like_tree``, as ``param_shardings`` returns; its mesh may differ
    from the one saved from) or, without ``shardings``, like its
    counterpart (a DTensor's mesh and placements, a tensor's device).
    Reads a sharded checkpoint or either package's one-file format.
    Returns (tree, manifest)."""
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    leaves = flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree has {len(leaves)}")
    metas = manifest.get("leaves") or [None] * len(leaves)
    targets = [None] * len(leaves) if shardings is None \
        else _sharding_leaves(shardings)
    if len(targets) != len(leaves):
        raise ValueError(f"shardings has {len(targets)} leaves, the tree "
                         f"has {len(leaves)}")
    files: dict = {}
    try:
        placed = iter([_place(_assemble(p, i, meta, files), leaf, target)
                       for i, (leaf, meta, target)
                       in enumerate(zip(leaves, metas, targets))])
    finally:
        for z in files.values():
            z.close()
    return tree_map(lambda _: next(placed), like_tree), manifest


def latest_step(root: str) -> Optional[int]:
    r = Path(root)
    if not r.exists():
        return None
    steps = [int(d.name.split("-")[1]) for d in r.iterdir()
             if d.is_dir() and d.name.startswith("step-") and
             (d / "manifest.json").exists()]
    return max(steps) if steps else None


class CheckpointManager:
    """Double-buffered async checkpointing with retention."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[_ShardedWrite] = None

    def dir_for(self, step: int) -> Path:
        return self.root / f"step-{step}"

    def save_async(self, tree, *, step: int, extra: Optional[dict] = None):
        self.wait()                          # double-buffer: at most 1 pending
        mesh = _tree_mesh(tree)
        if mesh is not None:                 # every rank of the mesh
            write = self._pending = _begin_sharded(
                self.dir_for(step), tree, mesh, step, extra)
            self._start(write)
            return
        host_tree = tree_map(_to_numpy, tree)   # snapshot now

        def work():
            save(self.dir_for(step), host_tree, step=step, extra=extra)
            self._gc()
        self._start(work)

    def _start(self, work) -> None:
        def run():
            try:
                work()
            except BaseException as e:      # noqa: BLE001  (re-raised by wait)
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_sync(self, tree, *, step: int, extra: Optional[dict] = None):
        self.wait()
        save(self.dir_for(step), tree, step=step, extra=extra)
        self._gc()

    def wait(self):
        """Join the pending write and raise its error; a sharded save is
        completed here, by every rank of its mesh, and a rank's failed
        write raises on all of them."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        write, self._pending = self._pending, None
        error, self._error = self._error, None
        if write is not None:                # raises on every rank on error
            write.finish(error)
            if write.rank == write.lead:
                self._gc()
        elif error is not None:
            raise error

    def restore_latest(self, like_tree, *, shardings=None):
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None
        return restore(self.dir_for(step), like_tree, shardings=shardings)

    def _gc(self):
        steps = sorted(int(d.name.split("-")[1]) for d in self.root.iterdir()
                       if d.is_dir() and d.name.startswith("step-"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step-{s}", ignore_errors=True)
