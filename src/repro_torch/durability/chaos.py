"""Control-plane crash points: enumerate every post-crash storage state.

The serverless chaos layer injects *worker* faults (duplicated/lost
invocations); this module injects *control-plane* deaths. Two mechanisms:

* ``CrashingStorage`` — a ``StorageBackend`` wrapper that kills the
  process (raises ``ProcessCrash``) on the Nth put, optionally writing a
  torn byte-prefix of the segment first — a live kill -9 mid-append.
* ``crash_states`` — offline enumeration: given the retained WAL+snapshot
  history of a COMPLETED run (``Journal(retain_segments=True)``), yield a
  fresh ``InMemoryStorage`` for every chronological record prefix the
  log ever passed through, plus torn-tail variants (next frame truncated
  mid-way; a byte of the last frame flipped). Recovery from each state +
  boundary-stamped catch-up must land bitwise-equal to the fault-free
  run.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..serverless.storage import InMemoryStorage, StorageBackend
from .journal import SNAP_PREFIX, WAL_PREFIX, _seq_of
from .wal import split_frames


class ProcessCrash(RuntimeError):
    """Simulated control-plane death (kill -9 mid-write)."""


class CrashingStorage(StorageBackend):
    """Delegate to ``inner``, but die on put number ``puts_before_crash``
    (0-based): the fatal put persists only the first ``torn_fraction`` of
    its bytes — the non-atomic append a real crash leaves behind — then
    raises ``ProcessCrash``. With ``corrupt=True`` the torn prefix also
    gets one byte flipped (simulated media error); recovery must drop it
    via checksum either way. Reads/deletes pass through untouched so the
    wrapped storage IS the post-crash disk."""

    def __init__(self, inner: StorageBackend, puts_before_crash: int,
                 *, torn_fraction: float = 0.5, corrupt: bool = False):
        self.inner = inner
        self.puts_before_crash = int(puts_before_crash)
        self.torn_fraction = float(torn_fraction)
        self.corrupt = corrupt
        self.puts = 0
        self.crashed = False

    def put(self, key: str, data: bytes) -> None:
        if self.crashed:
            raise ProcessCrash("storage used after simulated crash")
        if self.puts < self.puts_before_crash:
            self.puts += 1
            self.inner.put(key, data)
            return
        self.crashed = True
        cut = int(len(data) * self.torn_fraction)
        if cut > 0:
            torn = bytearray(data[:cut])
            if self.corrupt and torn:
                torn[len(torn) // 2] ^= 0xFF
            self.inner.put(key, bytes(torn))
        raise ProcessCrash(f"simulated crash on put #{self.puts} ({key})")

    def get(self, key: str) -> bytes:
        return self.inner.get(key)

    def list(self, prefix: str = "") -> List[str]:
        return self.inner.list(prefix)

    def delete(self, key: str) -> bool:
        if self.crashed:
            raise ProcessCrash("storage used after simulated crash")
        return self.inner.delete(key)

    def clear(self) -> None:
        self.inner.clear()

    def stats(self):
        return self.inner.stats()

    def close(self) -> None:
        self.inner.close()


def clone_to_memory(storage: StorageBackend) -> InMemoryStorage:
    """Copy any backend's objects into a fresh ``InMemoryStorage``."""
    mem = InMemoryStorage()
    for key in storage.list():
        mem.put(key, storage.get(key))
    return mem


def _chronological(storage: StorageBackend) -> List[str]:
    """WAL segments and snapshots interleaved in creation order: the
    snapshot with basis N was written after segment N-1 and before
    segment N, so it sorts as (N, 0) against a segment's (seq, 1)."""
    keys = []
    for k in storage.list(WAL_PREFIX):
        keys.append((_seq_of(k), 1, k))
    for k in storage.list(SNAP_PREFIX):
        keys.append((_seq_of(k), 0, k))
    return [k for _, _, k in sorted(keys)]


def crash_states(
    storage: StorageBackend, *, torn: bool = True, stride: int = 1,
) -> Iterator[Tuple[str, InMemoryStorage]]:
    """Yield ``(label, state)`` for every post-crash storage state a run
    could have died in, chronologically: before any write, after every
    prefix of records within every segment (``stride`` subsamples the
    interior but segment boundaries are always included), and — with
    ``torn=True`` — the same prefixes with the NEXT frame half-written
    or byte-flipped. Each state is an independent ``InMemoryStorage``."""
    stride = max(1, int(stride))
    base: List[Tuple[str, bytes]] = []

    def state(extra: Optional[Tuple[str, bytes]] = None) -> InMemoryStorage:
        mem = InMemoryStorage()
        for k, d in base:
            mem.put(k, d)
        if extra is not None:
            mem.put(*extra)
        return mem

    yield "empty", state()
    for key in _chronological(storage):
        data = storage.get(key)
        if key.startswith(SNAP_PREFIX):
            # snapshots are single atomic puts (mkstemp+replace); the
            # mid-write states are covered by the torn variants below
            if torn and len(data) > 1:
                yield (f"{key}@torn", state((key, data[: len(data) // 2])))
                flipped = bytearray(data)
                flipped[-1] ^= 0xFF
                yield (f"{key}@corrupt", state((key, bytes(flipped))))
            base.append((key, data))
            yield f"{key}@full", state()
            continue
        frames = split_frames(data)
        cuts = list(range(stride, len(frames), stride))
        if not cuts or cuts[-1] != len(frames):
            cuts.append(len(frames))
        for r in cuts:
            if torn:
                # crash mid-write of frame r-1: its prefix survives, or
                # survives with a flipped byte — checksum must drop it
                head = b"".join(frames[: r - 1])
                last = frames[r - 1]
                yield (f"{key}@{r - 1}+torn",
                       state((key, head + last[: max(1, len(last) // 2)])))
                flipped = bytearray(last)
                flipped[len(flipped) // 2] ^= 0xFF
                yield (f"{key}@{r - 1}+corrupt",
                       state((key, head + bytes(flipped))))
            yield f"{key}@{r}", state((key, b"".join(frames[:r])))
        base.append((key, data))
