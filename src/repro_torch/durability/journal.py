"""Group-commit write-ahead journal + snapshot/compaction + recovery.

The journal rides the ``serverless.storage.StorageBackend`` protocol
(``InMemoryStorage`` for tests and crash sweeps, ``FilesystemStorage``
with atomic fsync'd puts for real durability). Records buffer in memory
and flush as ONE segment object per commit — ``Castor.tick`` commits once
per scheduler cycle, so the fsync cost is batched per bin, never paid per
record.

Object layout (both key families sort chronologically)::

    wal/<seq>.log    one segment per commit, seq strictly increasing
    snap/<seq>.snap  full-state snapshot covering every segment < seq

Record stream invariants that make any-prefix recovery safe:

* effects (model versions, forecasts, detections, series appends) are
  journaled by the stores at mutation time, IN mutation order;
* the scheduler's watermark/retry delta for a tick is ONE atomic
  ``sched`` record appended AFTER the tick's effects — so a torn tail
  can only ever produce "effects persisted, watermark behind", never the
  reverse. Recovery then re-fires the whole boundary: the full-fleet bin
  re-executes with its original batch composition (bitwise-identical f32
  numerics), and the idempotent stores drop the already-journaled prefix;
* a detection bin's record subsumes its derived-signal write-back (the
  inner ``append_points`` is journal-suppressed), so detection state and
  derived series can never come apart across a torn tail.

What is deliberately NOT journaled: the ``ModelRegistry`` (implementation
classes are code artifacts — re-``publish`` after ``Castor.open``, like
re-deploying code), executor/runtime caches (device state is rebuilt cold,
bitwise-equal by the runtime's warm == cold contract), serverless worker
pools, the device the versions lay on, and the deterministic
``WeatherService`` (reconstructed from its journaled seed).

``snapshot()`` requires a quiescent control plane (no async serverless
run streaming absorbs concurrently): it reads full store state outside
any global mutation barrier. ``Castor.tick`` triggers it only between
cycles; call sites that stream (``run_async``) should snapshot after
``wait()``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .wal import decode_records, encode_record

WAL_PREFIX = "wal/"
SNAP_PREFIX = "snap/"


def wal_key(seq: int) -> str:
    return f"{WAL_PREFIX}{int(seq):012d}.log"


def snap_key(seq: int) -> str:
    return f"{SNAP_PREFIX}{int(seq):012d}.snap"


def _seq_of(key: str) -> int:
    return int(key.split("/", 1)[1].split(".", 1)[0])


class Journal:
    """Buffered, group-committed WAL over a ``StorageBackend``.

    ``append`` is what the stores call at mutation time; it buffers a
    framed record and auto-flushes past ``max_buffer_bytes`` (a bulk
    ingest must not accumulate unbounded memory). ``commit`` flushes the
    buffer as one segment — the durability point. ``suppressed()`` is a
    thread-local escape hatch for mutations that are subsumed by a
    coarser atomic record (the detection flow's derived write-back).
    """

    def __init__(self, storage, *, castor=None, snapshot_every: int = 0,
                 max_buffer_bytes: int = 4 << 20,
                 retain_segments: bool = False, pipelined: bool = False):
        self.storage = storage
        self.castor = castor
        self.snapshot_every = int(snapshot_every)
        self.max_buffer_bytes = int(max_buffer_bytes)
        #: keep compacted-away segments (chaos sweeps reconstruct every
        #: chronological crash state from the retained history)
        self.retain_segments = retain_segments
        #: hand each segment put to a writer thread so the fsync of tick
        #: k overlaps the compute of tick k+1 (at most ONE write in
        #: flight; the next flush waits for it first, so segments land
        #: strictly in seq order and a crash still loses only a suffix)
        self.pipelined = pipelined
        self._lock = threading.Lock()
        self._local = threading.local()
        self._buf: List[bytes] = []
        self._buf_bytes = 0
        self._seq = 0                      # next segment seq to write
        self._commits_since_snap = 0
        self._closed = False
        self._inflight: Optional[threading.Thread] = None
        self._write_err: Optional[BaseException] = None
        # telemetry (Castor.stats()["durability"])
        self.records = 0
        self.segments = 0
        self.bytes_written = 0
        self.snapshots = 0
        self.auto_flushes = 0

    # ------------------------------------------------------------ writes
    def start_at(self, seq: int) -> None:
        """First segment seq to write (recovery continues after the
        highest existing object so a torn tail is never overwritten)."""
        self._seq = int(seq)

    @contextmanager
    def suppressed(self):
        """Thread-locally drop ``append`` calls (re-entrant)."""
        prev = getattr(self._local, "off", 0)
        self._local.off = prev + 1
        try:
            yield
        finally:
            self._local.off = prev

    def append(self, op: str, obj: Any) -> None:
        if self._closed or getattr(self._local, "off", 0):
            return
        rec = encode_record(op, obj)
        with self._lock:
            if self._closed:
                return
            self._buf.append(rec)
            self._buf_bytes += len(rec)
            self.records += 1
            if self._buf_bytes >= self.max_buffer_bytes:
                self._flush_locked()
                self.auto_flushes += 1

    def commit(self) -> bool:
        """Flush buffered records as one segment (the group-commit /
        batched-fsync point); may trigger the periodic snapshot."""
        with self._lock:
            flushed = self._flush_locked()
        if self.snapshot_every and self.castor is not None \
                and self._commits_since_snap >= self.snapshot_every:
            self.snapshot()
        return flushed

    def _wait_inflight_locked(self) -> None:
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
        err, self._write_err = self._write_err, None
        if err is not None:
            raise err                      # surface at the NEXT commit

    def barrier(self) -> None:
        """Block until any in-flight pipelined segment write has landed
        (re-raising its error). A no-op for synchronous journals; crash
        tests call this before cloning the storage so the clone reflects
        the last commit deterministically."""
        with self._lock:
            self._wait_inflight_locked()

    def _write_async(self, key: str, data: bytes) -> None:
        from ..obs.trace import get_tracer
        try:
            # pipelined fsync: its span lives on the writer thread (a
            # root span there — the committing tick has already moved on)
            with get_tracer().span("journal.fsync", bytes=len(data)):
                self.storage.put(key, data)
        except BaseException as e:         # noqa: BLE001 — incl. chaos
            self._write_err = e

    def _flush_locked(self) -> bool:
        self._wait_inflight_locked()       # at most one write in flight
        if not self._buf:
            return False
        from ..obs.metrics import get_metrics
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        with tracer.span("journal.flush", records=len(self._buf)) as sp:
            data = b"".join(self._buf)
            sp.set(bytes=len(data))
            key = wal_key(self._seq)
            self._seq += 1
            self.segments += 1
            self.bytes_written += len(data)
            self._buf = []
            self._buf_bytes = 0
            self._commits_since_snap += 1
            m = get_metrics()
            m.counter("wal.flushes").inc()
            m.counter("wal.flushed_bytes").inc(len(data))
            m.histogram("wal.segment_bytes").observe(len(data))
            if self.pipelined:
                # the fsync'd put happens on the writer thread and
                # overlaps the next tick's compute; the span covers only
                # the handoff (the fsync span lands on the writer side)
                t = threading.Thread(target=self._write_async,
                                     args=(key, data), daemon=True)
                self._inflight = t
                t.start()
            else:
                with tracer.span("journal.fsync", bytes=len(data)):
                    self.storage.put(key, data)
        return True

    def snapshot(self) -> str:
        """Write a full-state snapshot covering all current segments,
        then delete them (compaction). Requires quiescence — see module
        docstring."""
        if self.castor is None:
            raise RuntimeError("journal has no castor attached")
        with self._lock:
            self._flush_locked()
            self._wait_inflight_locked()   # snap put is synchronous
            basis = self._seq
        recs = snapshot_records(self.castor)
        data = b"".join(recs)
        key = snap_key(basis)
        self.storage.put(key, data)
        self.snapshots += 1
        self.bytes_written += len(data)
        self._commits_since_snap = 0
        if not self.retain_segments:
            for k in self.storage.list(WAL_PREFIX):
                if _seq_of(k) < basis:
                    self.storage.delete(k)
            for k in self.storage.list(SNAP_PREFIX):
                if k != key:
                    self.storage.delete(k)
        return key

    def close(self) -> None:
        """Flush any open segment, then refuse further appends.
        Idempotent — ``Castor.close`` may run more than once."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._wait_inflight_locked()
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"records": self.records, "segments": self.segments,
                    "snapshots": self.snapshots,
                    "bytes_written": self.bytes_written,
                    "auto_flushes": self.auto_flushes,
                    "buffered_records": len(self._buf),
                    "buffered_bytes": self._buf_bytes,
                    "next_seq": self._seq}


# ------------------------------------------------------------- recovery


def load_records(storage) -> Tuple[List[Tuple[str, Any]], Dict[str, Any]]:
    """Read snapshot-then-WAL into one record list + recovery stats.

    The newest fully-valid snapshot is the base (corrupt snapshots fall
    back to older ones — compaction deletes predecessors only after a
    successful snapshot put, so a crash mid-snapshot always leaves a
    replayable history). WAL segments after the snapshot replay in
    sorted-key order; the first torn/corrupt segment ends the trusted
    prefix (its valid records are kept, everything after is dropped —
    never an exception)."""
    all_wal = sorted(storage.list(WAL_PREFIX))
    all_snaps = sorted(storage.list(SNAP_PREFIX))
    records: List[Tuple[str, Any]] = []
    basis = 0
    snapshot_used: Optional[str] = None
    corrupt_snapshots = 0
    for key in reversed(all_snaps):
        recs, _valid, clean = decode_records(storage.get(key))
        if clean and recs:
            records.extend(recs)
            basis = _seq_of(key)
            snapshot_used = key
            break
        corrupt_snapshots += 1
    torn_segments = 0
    dropped_segments = 0
    segments_replayed = 0
    hit_torn = False
    for key in all_wal:
        if _seq_of(key) < basis:
            continue                       # compacted into the snapshot
        if hit_torn:
            dropped_segments += 1
            continue
        recs, _valid, clean = decode_records(storage.get(key))
        records.extend(recs)
        segments_replayed += 1
        if not clean:
            torn_segments += 1
            hit_torn = True                # trust nothing after a tear
    seqs = [_seq_of(k) for k in all_wal] + [_seq_of(k) for k in all_snaps]
    stats = {"records": len(records), "snapshot": snapshot_used,
             "snapshot_basis": basis if snapshot_used else None,
             "segments_replayed": segments_replayed,
             "torn_segments": torn_segments,
             "dropped_segments": dropped_segments,
             "corrupt_snapshots": corrupt_snapshots,
             "next_seq": (max(seqs) + 1) if seqs else 0}
    return records, stats


def replay_records(castor, records: List[Tuple[str, Any]]) -> int:
    """Apply a record stream to a fresh (journal-less) castor. Replay is
    idempotent where live saves are idempotent, and record order is
    mutation order, so per-model version numbering comes out identical.
    Model versions land on ``castor.device``: the device is not journaled,
    so a log written on a card recovers on the CPU and the other way
    round.
    Unknown ops are skipped (forward compatibility), counted in the
    return value alongside applied records."""
    from ..core.deployment import deployment_from_record
    from ..core.lineage import forecasts_from_batch
    from ..core.semantics import Entity, Signal
    from ..flows.detection import DetectionRecord
    from ..forecast.base import version_from_numpy
    n = 0
    for op, d in records:
        n += 1
        if op == "ts":
            castor.store.append(d["id"], d["t"], d["v"])
        elif op == "tsp":
            castor.store.append_points(d["ids"], d["t"], d["v"])
        elif op == "mv":
            # decoded as numpy: onto this system's device, where a
            # recovered version scores like one trained here
            castor.versions.save(d["model_id"],
                                 version_from_numpy(d["params"],
                                                    castor.device),
                                 trained_at=d["trained_at"],
                                 metadata=d.get("metadata"))
        elif op == "fc":
            castor.predictions.save_many(forecasts_from_batch(d))
        elif op == "det":
            castor.detections.save_many(
                [DetectionRecord(**r) for r in d["records"]],
                write_back=bool(d.get("wb", True)))
        elif op == "sig":
            castor.graph.add_signal(Signal(d["name"], d.get("unit", ""),
                                           d.get("description", "")))
        elif op == "ent":
            castor.graph.add_entity(
                Entity(d["name"], d.get("kind", "ENTITY"),
                       d.get("lat", 0.0), d.get("lon", 0.0)),
                d.get("parent"))
        elif op == "lnk":
            castor.graph.link_timeseries(d["ts_id"], d["signal"],
                                         d["entity"])
        elif op == "dep":
            castor.deployments.register(deployment_from_record(d))
        elif op == "rmdep":
            castor.deployments.remove(d["name"])
        elif op == "sched":
            castor.scheduler.restore_state(d)
        elif op == "meta":
            pass
    return n


def meta_of(records: List[Tuple[str, Any]]) -> Optional[Dict[str, Any]]:
    for op, d in records:
        if op == "meta":
            return d
    return None


# ------------------------------------------------------------- snapshot


def snapshot_records(castor) -> List[bytes]:
    """The full system-of-record state as one framed record sequence — a
    snapshot is literally a compacted WAL, replayed by the exact same
    machinery. Detection records are emitted with ``wb=False``: the
    snapshotted series already contain every derived write-back."""
    from dataclasses import asdict

    from ..core.deployment import deployment_record
    from ..core.lineage import forecast_batch_record
    recs: List[bytes] = [encode_record("meta", {
        "format": 1, "weather_seed": castor.weather_seed})]
    g = castor.graph
    for sig in g.signals.values():
        recs.append(encode_record("sig", {
            "name": sig.name, "unit": sig.unit,
            "description": sig.description}))
    for name, ent in g.entities.items():    # insertion order: parents first
        p = g.parent(name)
        recs.append(encode_record("ent", {
            "name": ent.name, "kind": ent.kind, "lat": ent.lat,
            "lon": ent.lon, "parent": p.name if p is not None else None}))
    for (signal, entity), ts_id in list(g._ts.items()):
        recs.append(encode_record("lnk", {
            "ts_id": ts_id, "signal": signal, "entity": entity}))
    for ts_id in castor.store.ids():
        t, v = castor.store.read(ts_id)
        recs.append(encode_record("ts", {
            "id": ts_id, "t": np.asarray(t), "v": np.asarray(v)}))
    for dep in castor.deployments.all():
        recs.append(encode_record("dep", deployment_record(dep)))
    for model_id in castor.versions.model_ids():
        for mv in castor.versions.history(model_id):   # save order: the
            recs.append(encode_record("mv", {           # numbering replays
                "model_id": mv.model_id, "trained_at": mv.trained_at,
                "params": mv.params, "metadata": mv.metadata}))
    for name in castor.predictions.deployment_names():
        recs.append(encode_record(
            "fc", forecast_batch_record(castor.predictions.history(name))))
    for name in castor.detections.deployment_names():
        recs.append(encode_record("det", {
            "records": [asdict(r) for r in castor.detections.history(name)],
            "wb": False}))
    recs.append(encode_record("sched", castor.scheduler.dump_state()))
    return recs
