"""Invocation backends: where a serverless action physically runs.

``InvocationBackend`` is the protocol the invoker drives; two
implementations ship:

* ``InlineBackend`` — deterministic, in-process: each worker slot is a
  warm ``Worker`` over the SHARED system (persistence happens directly
  through the executor, artifacts never cross a wire). This is the
  test/reference path, and the one for tens of thousands of tasks —
  invocation machinery without OS-process cost; its workers share the
  system's card. It
  is also where ``ChaosPolicy`` faults inject (deterministic in-process
  reproduction of kill/drop/duplicate/delay), and it can optionally
  round-trip payloads/results through a ``StorageBackend`` to prove the
  store-mediated path without process cost.
* ``ProcessBackend`` — real OS containers: spawned worker processes, each
  building its own system replica from a picklable factory at cold start
  (spawn, never fork — CUDA cannot be used in a forked child of a parent
  that initialised it). A replica built with ``device="cuda"`` opens its
  own CUDA context on the card and loads the kernels the parent built
  under ``build/repro_torch/`` (build them before the first spawn, or
  the first child compiles them inside its cold start). By default
  payloads/results travel through a shared ``FilesystemStorage`` bucket
  and the mp queues carry only object KEYS
  (the Lithops storage-mediated path — an aggregation-128 action no
  longer serializes through one JSON pipe); ``storage_dir=None`` falls
  back to raw JSON strings over the wire. Artifacts (trained versions,
  forecasts) ship back for the invoker to persist idempotently.

Both backends are ELASTIC: ``add_worker``/``remove_worker`` grow and reap
the warm pool at runtime (worker ids are never reused), which is what the
autoscaler drives. Both serialize invocations PER WORKER (a warm
container runs one action at a time); cross-worker parallelism is the
invoker's in-flight bound.

``ProcessBackend`` reaps its spawned workers via a ``weakref.finalize``
teardown (GC of a leaked backend — e.g. a test that failed mid-run — and
interpreter exit both kill the children, CUDA contexts and all), plus
context-manager support for explicit scoping.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

from .chaos import ChaosPolicy
from .payload import InvocationPayload, InvocationResult
from .storage import (FilesystemStorage, StorageBackend, get_payload,
                      get_result, put_payload, put_result)
from .worker import Worker, _process_worker_main


class InvocationError(RuntimeError):
    """An invocation failed at the backend level (worker died, transport
    error) — the whole action is retriable on another worker."""


class InvocationBackend:
    """Protocol: ``invoke`` blocks until the action completes on the given
    worker (the invoker provides cross-invocation concurrency)."""

    #: worker artifacts must ship back for the invoker to persist (False
    #: when workers write straight into the shared stores)
    wants_artifacts: bool = False

    def worker_ids(self) -> List[str]:
        raise NotImplementedError

    def invoke(self, payload: InvocationPayload,
               worker_id: str) -> InvocationResult:
        raise NotImplementedError

    # ------------------------------------------------------- elasticity
    def add_worker(self) -> str:
        """Provision one more warm-container slot; returns its id (never
        a reused one)."""
        raise NotImplementedError

    def remove_worker(self, worker_id: str) -> bool:
        """Reap a container (discarding its warmth). Returns False when
        the worker is unknown or currently executing an action."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class InlineBackend(InvocationBackend):
    wants_artifacts = False

    def __init__(self, system, *, n_workers: int = 4,
                 storage: Optional[StorageBackend] = None,
                 chaos: Optional[ChaosPolicy] = None):
        self.system = system
        self.n_workers = max(1, int(n_workers))
        self.storage = storage
        self.chaos = chaos
        self._ids = [f"w{i}" for i in range(self.n_workers)]
        self._next_id = self.n_workers
        self._workers: Dict[str, Worker] = {}
        self._locks = {w: threading.Lock() for w in self._ids}
        self._guard = threading.Lock()

    def worker_ids(self) -> List[str]:
        with self._guard:
            return list(self._ids)

    def add_worker(self) -> str:
        with self._guard:
            w = f"w{self._next_id}"
            self._next_id += 1
            self._ids.append(w)
            self._locks[w] = threading.Lock()
            return w

    def remove_worker(self, worker_id: str) -> bool:
        with self._guard:
            lock = self._locks.get(worker_id)
            if lock is None:
                return False
            if not lock.acquire(blocking=False):
                return False               # mid-action: not reapable now
            try:
                self._ids.remove(worker_id)
                del self._locks[worker_id]
                self._workers.pop(worker_id, None)
            finally:
                lock.release()
            return True

    def _worker(self, worker_id: str) -> Worker:
        with self._guard:
            if worker_id not in self._locks:
                raise InvocationError(f"{worker_id} is not a live worker")
            w = self._workers.get(worker_id)
            if w is None:                      # cold start: build the slot
                w = self._workers[worker_id] = Worker(
                    worker_id, self.system, collect_artifacts=False)
            return w, self._locks[worker_id]

    def invoke(self, payload: InvocationPayload,
               worker_id: str) -> InvocationResult:
        if self.storage is not None:
            # store-mediated path: the "wire" carries only the key; what
            # the worker executes is what came back OUT of the store
            key = put_payload(self.storage, payload)
            payload = get_payload(self.storage, key)
        w, lock = self._worker(worker_id)
        chaos = self.chaos
        duplicate = chaos is not None and chaos.should_duplicate(payload)
        with lock:                             # one action at a time
            if duplicate:
                # at-least-once delivery: the first copy executes with
                # full effects; the SECOND copy's result is what returns
                w.execute(payload)
            result = w.execute(payload, chaos=chaos)
        if self.storage is not None:
            rkey = put_result(self.storage, result, payload.attempt)
            result = get_result(self.storage, rkey)
        if chaos is not None and chaos.should_drop(payload):
            # the action ran — its effects are persisted — but the result
            # never makes it back: the canonical at-least-once retry case
            raise InvocationError(
                f"chaos: result of {payload.invocation_id} dropped")
        return result


def _reap_processes(procs: Dict[str, tuple]) -> None:
    """Best-effort teardown shared by ``close()``, GC finalization and
    interpreter exit: without it, a crashed invoker (a test failing
    mid-run) leaked its spawned workers for the rest of the test run."""
    items = list(procs.items())
    procs.clear()
    for _, (proc, task_q, _rq) in items:
        try:
            task_q.put_nowait(None)
        except Exception:  # noqa: BLE001
            pass
    for _, (proc, _tq, _rq) in items:
        try:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
        except Exception:  # noqa: BLE001
            pass


class ProcessBackend(InvocationBackend):
    wants_artifacts = True

    def __init__(self, system_factory: Callable[[], object], *,
                 n_workers: int = 2, env: Optional[Dict[str, str]] = None,
                 invoke_timeout_s: float = 600.0,
                 spawn_timeout_s: float = 300.0,
                 storage_dir: Optional[str] = "auto"):
        self.system_factory = system_factory
        self.n_workers = max(1, int(n_workers))
        self.env = dict(env or {})
        self.invoke_timeout_s = invoke_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        # "auto": a fresh owned tempdir bucket; a path: a shared bucket;
        # None: legacy raw-JSON-over-the-pipe transport
        if storage_dir == "auto":
            self.storage: Optional[FilesystemStorage] = FilesystemStorage()
        elif storage_dir is not None:
            self.storage = FilesystemStorage(storage_dir)
        else:
            self.storage = None
        self._ids = [f"p{i}" for i in range(self.n_workers)]
        self._next_id = self.n_workers
        self._procs: Dict[str, tuple] = {}     # id -> (proc, task_q, result_q)
        self._locks = {w: threading.Lock() for w in self._ids}
        self._guard = threading.Lock()
        # reap spawned children when this backend is GC'd (crashed
        # invoker, failed test) or the interpreter exits — the finalizer
        # must not hold a reference to self, only to the procs dict
        self._finalizer = weakref.finalize(self, _reap_processes,
                                           self._procs)

    def worker_ids(self) -> List[str]:
        with self._guard:
            return list(self._ids)

    def add_worker(self) -> str:
        with self._guard:
            w = f"p{self._next_id}"
            self._next_id += 1
            self._ids.append(w)
            self._locks[w] = threading.Lock()
            return w                           # process spawns lazily

    def remove_worker(self, worker_id: str) -> bool:
        with self._guard:
            lock = self._locks.get(worker_id)
            if lock is None:
                return False
            if not lock.acquire(blocking=False):
                return False
            try:
                self._ids.remove(worker_id)
                del self._locks[worker_id]
                entry = self._procs.pop(worker_id, None)
            finally:
                lock.release()
        if entry is not None:
            _reap_processes({worker_id: entry})
        return True

    def _spawn(self, worker_id: str) -> tuple:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        task_q: "mp.Queue" = ctx.Queue()
        result_q: "mp.Queue" = ctx.Queue()
        proc = ctx.Process(
            target=_process_worker_main,
            args=(task_q, result_q, self.system_factory, worker_id,
                  self.env,
                  self.storage.root if self.storage is not None else None),
            daemon=True, name=f"serverless-{worker_id}")
        proc.start()
        import queue as _q
        deadline = time.time() + self.spawn_timeout_s
        while True:
            try:
                tag, info = result_q.get(timeout=1.0)
                break
            except _q.Empty:
                # a child that dies during interpreter bootstrap (before
                # our handshake code runs) never posts anything: detect
                # the corpse instead of burning the whole spawn timeout
                if not proc.is_alive():
                    raise InvocationError(
                        f"{worker_id}: worker process died during cold "
                        f"start (exit {proc.exitcode})")
                if time.time() > deadline:
                    proc.kill()
                    raise InvocationError(
                        f"{worker_id}: cold start timed out")
        if tag != "ready":
            raise InvocationError(f"{worker_id}: cold start failed: {info}")
        return proc, task_q, result_q

    def _worker(self, worker_id: str) -> tuple:
        with self._guard:
            if worker_id not in self._locks:
                raise InvocationError(f"{worker_id} is not a live worker")
            entry = self._procs.get(worker_id)
            if entry is None or not entry[0].is_alive():
                entry = self._procs[worker_id] = self._spawn(worker_id)
            return entry, self._locks[worker_id]

    def invoke(self, payload: InvocationPayload,
               worker_id: str) -> InvocationResult:
        import queue as _q
        (proc, task_q, result_q), lock = self._worker(worker_id)
        with lock:
            if self.storage is not None:
                # storage-mediated: bytes go through the shared bucket,
                # the pipe carries a ~100-byte key reference
                key = put_payload(self.storage, payload)
                task_q.put(("ref", key))
            else:
                task_q.put(payload.to_json())
            deadline = time.time() + self.invoke_timeout_s
            while True:
                try:
                    tag, iid, body = result_q.get(timeout=min(
                        1.0, max(0.05, deadline - time.time())))
                except _q.Empty:
                    if not proc.is_alive():
                        with self._guard:
                            self._procs.pop(worker_id, None)
                        raise InvocationError(
                            f"{worker_id} died mid-invocation "
                            f"(exit {proc.exitcode})")
                    if time.time() > deadline:
                        raise InvocationError(
                            f"{worker_id}: invocation timed out")
                    continue
                # a predecessor that timed out here may deliver late:
                # drop stale messages (result OR error) until OUR
                # invocation's answer arrives — the stale one's effects
                # are idempotent, and its error must not be attributed to
                # (and burn the retry budget of) the current invocation.
                # An empty id means the worker could not even parse the
                # payload; that can only be the head-of-line message, i.e.
                # ours, since the queue is FIFO per worker.
                if iid and iid != payload.invocation_id:
                    continue
                if tag == "result-ref":
                    return get_result(self.storage, body)
                if tag != "result":
                    raise InvocationError(f"{worker_id}: {body}")
                return InvocationResult.from_json(body)

    def close(self) -> None:
        with self._guard:
            procs = dict(self._procs)
            self._procs.clear()
        _reap_processes(procs)
        if self.storage is not None:
            self.storage.close()
        self._finalizer.detach()
