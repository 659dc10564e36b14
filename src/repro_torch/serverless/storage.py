"""Object-store-mediated payload/result transport (the Lithops
``storage/backends`` role, adapted).

Real serverless frameworks do not push megabyte payloads through the
invocation API: the invoker *puts* the job payload into an object store,
the worker *gets* it by key, and results travel the same way — the
invocation channel carries only small references. This module provides
that mediation layer so an aggregation-128 action (and its worker-shipped
forecasts) no longer serializes through one JSON pipe per action:

* ``StorageBackend`` — the ``put/get/list/delete`` protocol, bytes-valued.
* ``InMemoryStorage`` — dict-backed; deterministic, the inline/test path.
* ``FilesystemStorage`` — files under a root directory with atomic
  (write-temp-then-rename) puts, so a reader in ANOTHER PROCESS can never
  observe a partially written object. This is what ``ProcessBackend``
  uses by default: the mp queue carries only keys, payload/result bytes
  go through the shared filesystem "bucket".

Key layout mirrors Lithops' ``lithops.jobs/<job>/...`` convention, with
the attempt number in the key so duplicate deliveries and stale retries
write distinct objects instead of racing on one:

    jobs/<invocation_id>/a<attempt>.json      (payload)
    results/<invocation_id>/a<attempt>.json   (result)

Everything stored is the bitwise JSON encoding from ``payload.py`` —
round-tripping through a storage backend is covered by property tests in
``tests/test_torch_serverless.py``.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

from .payload import InvocationPayload, InvocationResult

_KEY_RE = re.compile(r"^[A-Za-z0-9._\-/]+$")


class StorageKeyError(KeyError):
    """Requested object does not exist in the storage backend."""


class StorageBackend:
    """Bytes-valued object store protocol. Implementations must be safe
    for concurrent use from multiple threads (and, for the filesystem
    backend, multiple processes)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """All keys under ``prefix``, sorted (deterministic)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def clear(self) -> None:
        for k in self.list():
            self.delete(k)

    def stats(self) -> Dict[str, int]:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _check_key(key: str) -> str:
    if not key or not _KEY_RE.match(key) or ".." in key.split("/"):
        raise ValueError(f"invalid storage key {key!r}")
    return key


class _Counters:
    """Thread-safe put/get byte counters shared by both backends."""

    def __init__(self):
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0
        self.deletes = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def on_put(self, n: int) -> None:
        with self._lock:
            self.puts += 1
            self.bytes_in += n

    def on_get(self, n: int) -> None:
        with self._lock:
            self.gets += 1
            self.bytes_out += n

    def on_delete(self) -> None:
        with self._lock:
            self.deletes += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"puts": self.puts, "gets": self.gets,
                    "deletes": self.deletes, "bytes_in": self.bytes_in,
                    "bytes_out": self.bytes_out}


class InMemoryStorage(StorageBackend):
    """Deterministic in-process object store (the inline/test path)."""

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._counters = _Counters()

    def put(self, key: str, data: bytes) -> None:
        _check_key(key)
        data = bytes(data)
        with self._lock:
            self._objects[key] = data
        self._counters.on_put(len(data))

    def get(self, key: str) -> bytes:
        with self._lock:
            data = self._objects.get(key)
        if data is None:
            raise StorageKeyError(key)
        self._counters.on_get(len(data))
        return data

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> bool:
        with self._lock:
            hit = self._objects.pop(key, None) is not None
        if hit:
            self._counters.on_delete()
        return hit

    def stats(self) -> Dict[str, int]:
        out = self._counters.snapshot()
        with self._lock:
            out["objects"] = len(self._objects)
        return out


class FilesystemStorage(StorageBackend):
    """Object store over a directory tree — the cross-process backend.

    Puts are atomic (temp file in the same directory, then ``os.replace``)
    so a concurrent reader in another process either misses the key or
    sees the complete object, never a torn one. ``owned`` roots (the
    default when ``root`` is omitted: a fresh tempdir) are deleted on
    ``close()``.

    ``fsync=True`` (what ``Castor.open`` uses for its WAL) additionally
    fsyncs the temp file before the rename and the directory after it,
    so a completed ``put`` survives power loss, not just process death.
    """

    def __init__(self, root: Optional[str] = None, *, fsync: bool = False):
        self._owned = root is None
        self.root = root or tempfile.mkdtemp(prefix="repro-objstore-")
        self.fsync = fsync
        os.makedirs(self.root, exist_ok=True)
        self._counters = _Counters()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, _check_key(key))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)          # atomic publish
            if self.fsync:                 # persist the rename itself
                dfd = os.open(os.path.dirname(path), os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._counters.on_put(len(data))

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise StorageKeyError(key) from None
        self._counters.on_get(len(data))
        return data

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, dirs, files in os.walk(self.root):
            # os.walk surfaces entries in os.listdir order, which is
            # filesystem-dependent; sort the traversal itself so the
            # result is deterministic on every platform even before the
            # final sort (and any future early-exit iteration stays so)
            dirs.sort()
            for name in sorted(files):
                if name.startswith(".tmp-"):
                    continue               # in-flight atomic put
                key = os.path.relpath(os.path.join(dirpath, name),
                                      self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            return False
        self._counters.on_delete()
        return True

    def stats(self) -> Dict[str, int]:
        out = self._counters.snapshot()
        out["objects"] = len(self.list())
        return out

    def close(self) -> None:
        if self._owned:
            shutil.rmtree(self.root, ignore_errors=True)


# ------------------------------------------------------- payload helpers
#
# One key scheme shared by every backend, attempt-qualified so duplicate
# deliveries / stale retries never collide on an object.


def payload_key(invocation_id: str, attempt: int) -> str:
    return f"jobs/{invocation_id}/a{int(attempt):03d}.json"


def result_key(invocation_id: str, attempt: int) -> str:
    return f"results/{invocation_id}/a{int(attempt):03d}.json"


def put_payload(storage: StorageBackend, payload: InvocationPayload) -> str:
    key = payload_key(payload.invocation_id, payload.attempt)
    storage.put(key, payload.to_json().encode("utf-8"))
    return key


def get_payload(storage: StorageBackend, key: str) -> InvocationPayload:
    return InvocationPayload.from_json(storage.get(key).decode("utf-8"))


def put_result(storage: StorageBackend, result: InvocationResult,
               attempt: int) -> str:
    key = result_key(result.invocation_id, attempt)
    storage.put(key, result.to_json().encode("utf-8"))
    return key


def get_result(storage: StorageBackend, key: str) -> InvocationResult:
    return InvocationResult.from_json(storage.get(key).decode("utf-8"))
