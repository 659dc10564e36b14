"""Asynchronous, atomic checkpointing of a tensor tree.

The on-disk format is the JAX package's (``repro.distributed.checkpoint``),
so a checkpoint written by either package restores into the other:

  * ``shard-0.npz`` holds the leaves as ``a0 .. an`` in the reference's
    flatten order: dict keys sorted, ``NamedTuple`` fields in order (the
    AdamW state), tuples and lists in order, ``None`` no leaf;
  * ``manifest.json`` records the step, the leaf count, a description of
    the tree, the process count (1: one process, one card) and ``extra``.
  * ASYNC: ``save_async`` copies the tensors to host memory synchronously
    and writes on a background thread, at most one write pending.
  * ATOMIC: writes go to ``<dir>.tmp``, then a rename; a crash mid-save
    never corrupts the latest complete checkpoint.

A leaf restores with the dtype and device of the tree it restores into.
bf16 tensors are written as f32 (numpy has no bf16) and cast back.
Sharded multi-process writes wait for the multi-GPU slice.
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
    """Synchronous save (one process: one shard file)."""
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


def restore(path: str, like_tree):
    """Restore into the structure of ``like_tree``: each tensor leaf takes
    the dtype and device of its counterpart there. Returns (tree,
    manifest)."""
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    leaves = flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree has {len(leaves)}")
    with np.load(p / "shard-0.npz") as z:
        arrays = iter([z[f"a{i}"] for i in range(len(leaves))])

    def one(leaf):
        arr = next(arrays)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr
    return tree_map(one, like_tree), manifest


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

    def dir_for(self, step: int) -> Path:
        return self.root / f"step-{step}"

    def save_async(self, tree, *, step: int, extra: Optional[dict] = None):
        self.wait()                          # double-buffer: at most 1 pending
        host_tree = tree_map(_to_numpy, tree)   # snapshot now

        def work():
            try:
                save(self.dir_for(step), host_tree, step=step, extra=extra)
                self._gc()
            except BaseException as e:      # noqa: BLE001  (re-raised by wait)
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, tree, *, step: int, extra: Optional[dict] = None):
        self.wait()
        save(self.dir_for(step), tree, step=step, extra=extra)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_latest(self, like_tree):
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None
        return restore(self.dir_for(step), like_tree)

    def _gc(self):
        steps = sorted(int(d.name.split("-")[1]) for d in self.root.iterdir()
                       if d.is_dir() and d.name.startswith("step-"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step-{s}", ignore_errors=True)
