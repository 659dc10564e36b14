"""The Castor system facade: wires the knowledge store, registry, deployments,
scheduler, executors and lineage into the paper's workflow (Fig. 1):

    (1) ingest -> (2) semantics -> (3/4) implement+publish -> (5/6) deploy ->
    (7) schedule -> (8/9) execute -> (10) persist forecasts.

``device`` (default ``"cuda"``) is where fleet scoring runs: the executor's
runtime state, the stacked model versions and the kernels all live there.
Asking for ``"cuda"`` without a card raises; the CPU runs only when asked
for, as the tests do. ``Castor.open`` makes a system durable (a journal of
every system-of-record mutation, recovered bitwise); the device is not
journaled, so a log written on a card recovers on the CPU and the other
way round.
"""
from __future__ import annotations

from typing import List, Optional

from ..kernels.common import resolve_device
from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer
from ..timeseries.store import TimeSeriesStore
from ..timeseries.weather import WeatherService
from .deployment import DeploymentStore, ModelDeployment, deploy_for_all
from .executor import FleetExecutor, JobResult, LocalPoolExecutor
from .lineage import ModelVersionStore, PredictionStore
from .registry import ModelRegistry
from .scheduler import ModelScheduler, Schedule
from .semantics import Context, Entity, SemanticGraph, Signal


class Castor:
    def __init__(self, *, device="cuda", weather_seed: int = 7):
        self.device = resolve_device(device)
        self.weather_seed = weather_seed
        self.store = TimeSeriesStore()
        self.graph = SemanticGraph()
        self.registry = ModelRegistry()
        self.deployments = DeploymentStore()
        self.versions = ModelVersionStore()
        self.predictions = PredictionStore()
        from ..flows.detection import DetectionStore
        self.detections = DetectionStore(self.store, self.graph)
        self.weather = WeatherService(seed=weather_seed)
        self.scheduler = ModelScheduler(self.deployments, self.registry)
        self.journal = None            # durability.Journal when open()'d
        self._durable_storage = None   # backend owned by open(path=...)

    # ---------------- durability (WAL + recovery) ----------------
    @classmethod
    def open(cls, path: Optional[str] = None, *, storage=None,
             device="cuda", weather_seed: int = 7, fsync: bool = True,
             snapshot_every: int = 64,
             max_buffer_bytes: int = 4 << 20,
             retain_segments: bool = False,
             pipelined_commit: bool = True) -> "Castor":
        """Open a DURABLE Castor on ``device``: recover state from
        ``path`` (a WAL+snapshot directory; created empty if absent) or any
        ``StorageBackend`` via ``storage=``, then journal every
        system-of-record mutation from here on. Records group-commit as
        one fsync'd segment per ``tick`` (plus a ``max_buffer_bytes``
        overflow flush), and every ``snapshot_every`` flushed segments the
        log compacts into a full-state snapshot.

        Recovery replays snapshot-then-WAL into bitwise-equal stores and
        re-arms the calendar queue; a torn/corrupt WAL tail (crash
        mid-write) is dropped at the first bad checksum, and the
        boundary-stamped catch-up machinery re-fires anything the lost
        suffix contained. Recovered model versions land on ``device``
        (the journal holds their numpy image, not where they lay). Model
        *implementations* are code, not data — re-``publish`` packages
        after opening, then ``deploy_for_all``/``tick`` as usual.

        ``pipelined_commit`` (default on) hands each segment put to a
        writer thread so tick k's fsync overlaps tick k+1's compute; at
        most one write is ever in flight and segments land in order, so
        a crash still loses only a suffix of recent work. ``close()``
        (and ``Journal.barrier()``) block until the last write lands."""
        from ..durability.journal import (Journal, load_records, meta_of,
                                          replay_records)
        owned = None
        if storage is None:
            if path is None:
                raise ValueError("Castor.open needs a path or a storage=")
            from ..serverless.storage import FilesystemStorage
            storage = owned = FilesystemStorage(root=path, fsync=fsync)
        records, rec_stats = load_records(storage)
        meta = meta_of(records)
        if meta is not None:
            weather_seed = int(meta.get("weather_seed", weather_seed))
        c = cls(device=device, weather_seed=weather_seed)
        replay_records(c, records)     # journal-less: replay re-journals
        journal = Journal(storage, castor=c,          # nothing
                          snapshot_every=snapshot_every,
                          max_buffer_bytes=max_buffer_bytes,
                          retain_segments=retain_segments,
                          pipelined=pipelined_commit)
        journal.start_at(rec_stats["next_seq"])
        c._recovery_stats = rec_stats
        c._durable_storage = owned
        c._attach_journal(journal)
        if meta is None:               # first open: persist the seed
            journal.append("meta", {"format": 1,
                                    "weather_seed": weather_seed})
        return c

    def _attach_journal(self, journal) -> None:
        """Point every system of record at the journal. Hooks fire inside
        the stores' own locks; the journal's lock nests strictly inside
        and never calls back out, so lock order is acyclic."""
        self.journal = journal
        for store in (self.store, self.versions, self.predictions,
                      self.detections, self.deployments, self.graph):
            store.journal = journal

    def _detach_journal(self) -> None:
        self.journal = None
        for store in (self.store, self.versions, self.predictions,
                      self.detections, self.deployments, self.graph):
            store.journal = None

    def _commit_tick(self) -> None:
        """Group-commit one tick's records: the scheduler's watermark/
        retry delta journals as ONE atomic record AFTER the tick's
        effects (so a torn tail can only under-report progress, never
        drop effects a watermark already covers), then the whole buffer
        flushes as one segment — one storage put / fsync per tick, not
        per record."""
        j = self.journal
        if j is None:
            return
        delta = self.scheduler.drain_dirty()
        if delta is not None:
            j.append("sched", delta)
        j.commit()

    # ---------------- (1)/(2) data + semantics ----------------
    def ingest(self, ts_id: str, times, values) -> int:
        return self.store.append(ts_id, times, values)

    def add_signal(self, name: str, unit: str = "", description: str = "") -> Signal:
        return self.graph.add_signal(Signal(name, unit, description))

    def add_entity(self, name: str, kind: str = "ENTITY", lat: float = 0.0,
                   lon: float = 0.0, parent: Optional[str] = None) -> Entity:
        return self.graph.add_entity(Entity(name, kind, lat, lon), parent)

    def link(self, ts_id: str, signal: str, entity: str) -> Context:
        return self.graph.link_timeseries(ts_id, signal, entity)

    # ---------------- (3)/(4) implementations ----------------
    def publish(self, package: str, version: str, cls):
        return self.registry.register(package, version, cls)

    # ---------------- (5)/(6) deployments ----------------
    def deploy(self, dep: ModelDeployment) -> ModelDeployment:
        return self.deployments.register(dep)

    def deploy_for_all(self, **kw) -> List[ModelDeployment]:
        return deploy_for_all(self.graph, self.deployments, **kw)

    def deploy_detections(self, **kw) -> List[ModelDeployment]:
        """Detection-flow fleet deployment: one minutely
        ``DetectionDeployment`` per entity carrying ``signal`` (see
        flows.detection.deploy_detections_for_all)."""
        from ..flows.detection import deploy_detections_for_all
        return deploy_detections_for_all(self.graph, self.deployments, **kw)

    def undeploy(self, name: str) -> None:
        """Remove a deployment. The store's listener protocol clears the
        scheduler's calendar entry, watermark and queued retries for the
        name, so a later same-name ``deploy`` fires from scratch."""
        self.deployments.remove(name)

    # ---------------- (7)-(10) execution ----------------
    def tick(self, now: float, *, executor: str = "fleet",
             max_parallel: int = 16) -> List[JobResult]:
        """One scheduler cycle: poll due jobs, execute, persist.

        ``executor`` names an engine behind the shared ``run(jobs)``
        protocol (see core/executor.py): "fleet" (megabatched on the
        system's device; its ``FleetRuntime`` persists across ticks so
        consecutive polls pay O(delta) instead of O(history) — see
        core/runtime.py), "serverless" (the invocation pipeline in
        serverless/; its warm workers share this system and its card, and
        persist across ticks), or "local" (the paper-faithful stateless
        pool, built per call). A durable system group-commits the tick's
        records at its end, also after an empty poll and when the
        executor raised."""
        tracer = self.tracer
        with tracer.span("castor.tick", now=now, executor=executor):
            jobs = self.scheduler.poll(now)
            if not jobs:
                with tracer.span("journal.commit"):
                    self._commit_tick()    # flush buffered ingest records
                return []
            if executor == "fleet":
                ex = self.fleet_executor(max_parallel=max_parallel)
            elif executor == "serverless":
                # honored on FIRST construction (the executor is cached)
                ex = self.serverless_executor(max_in_flight=max_parallel)
            elif executor == "local":
                ex = LocalPoolExecutor(self, max_parallel=max_parallel)
            else:
                raise ValueError(f"unknown executor {executor!r} "
                                 "(expected fleet | serverless | local)")
            try:
                return ex.run(jobs)
            finally:
                # the group-commit point: effects first, then the
                # scheduler delta, one segment put — even when the
                # executor raised (any persisted effects plus
                # ``mark_failed`` retry stamps)
                with tracer.span("journal.commit"):
                    self._commit_tick()

    def fleet_executor(self, *, max_parallel: int = 16) -> FleetExecutor:
        """The system's long-lived fleet executor (steady-state runtime
        state lives here); rebuilt only if the pool size changes."""
        cached = getattr(self, "_fleet_ex", None)
        if cached is None or cached[0] != max_parallel:
            ex = FleetExecutor(self, fallback=LocalPoolExecutor(
                self, max_parallel=max_parallel))
            self._fleet_ex = cached = (max_parallel, ex)
        return cached[1]

    def serverless_executor(self, **kw):
        """The system's long-lived serverless executor (warm-container
        affinity lives here — its workers' FleetRuntimes stay warm across
        ticks). Keyword args configure only the FIRST construction;
        rebuild explicitly via ``serverless.ServerlessExecutor`` for
        custom backends (a ``ProcessBackend`` of spawned workers)."""
        ex = getattr(self, "_serverless_ex", None)
        if ex is None:
            from ..serverless import ServerlessExecutor
            ex = self._serverless_ex = ServerlessExecutor(self, **kw)
        return ex

    def run_until(self, t0: float, t1: float, step: float,
                  executor: str = "fleet") -> List[JobResult]:
        """Index-based stepping (``t = t0 + k*step``, never ``t += step``):
        accumulated float error over a long simulated horizon would
        otherwise drift the poll instants off the scheduler's boundary
        lattice. The step count is fixed up front with a relative epsilon
        so a final boundary whose ``k*step`` rounds a hair above ``t1``
        still fires; a t1 genuinely between boundaries floors."""
        if step <= 0:
            raise ValueError(f"step must be positive, got {step}")
        out = []
        r = (t1 - t0) / step
        n = max(0, int(r + 1e-9 * max(1.0, r))) if t1 >= t0 else -1
        for k in range(n + 1):
            out.extend(self.tick(t0 + k * step, executor=executor))
        return out

    # ---------------- retrieval (semantic APIs) ----------------
    def read(self, signal: str, entity: str, start=None, end=None):
        ctx = self.graph.context(signal, entity)
        return self.store.read(ctx.ts_id, start, end)

    def read_many(self, pairs, start=None, end=None):
        """Batched semantic reads: ``pairs`` is [(signal, entity), ...];
        all series are fetched in ONE ``store.read_many`` round-trip."""
        ids = [self.graph.context(s, e).ts_id for s, e in pairs]
        return self.store.read_many(ids, start, end)

    def compact(self):
        """Consolidate every series to one sorted segment (post-bulk-ingest
        hook so the next fleet read is a pure binary-search slice)."""
        self.store.compact()

    def best_forecast(self, signal: str, entity: str,
                      at: Optional[float] = None, *,
                      return_bands: bool = False):
        """Best-ranked most-recent forecast for a context (``at=`` replays
        the forecast a live consumer would have seen at that instant).
        With ``return_bands=True`` returns ``(times, values, lower,
        upper)`` or None if no forecast exists."""
        fc = self.predictions.latest(signal, entity, at)
        if not return_bands:
            return fc
        if fc is None:
            return None
        return fc.times, fc.values, fc.lower, fc.upper

    # ---------------- observability plane (obs/) ----------------
    @property
    def tracer(self):
        """The process-global span tracer (obs/trace.py)."""
        return get_tracer()

    @property
    def metrics(self):
        """The process-global metrics registry (obs/metrics.py)."""
        return get_metrics()

    def dump_trace(self, path) -> str:
        """Write every buffered span as Chrome trace-event JSON — open
        the file at ui.perfetto.dev (or chrome://tracing)."""
        from ..obs.export import write_chrome_trace
        return str(write_chrome_trace(path, self.tracer))

    def _mirror_metrics(self) -> None:
        """Absorb the scattered per-subsystem counters into the one
        namespaced registry (snapshot-time mirroring: the hot paths that
        maintain these counters stay untouched)."""
        m = self.metrics
        st = self.store.stats()
        m.gauge("store.points").set(st["points"])
        m.gauge("store.segments").set(st["segments"])
        m.gauge("store.reads").set(st["reads"])
        m.gauge("store.read_many").set(st["read_many"])
        m.gauge("store.delta_reads").set(st["delta_reads"])
        from ..forecast.base import rollout_cache_stats
        rc = rollout_cache_stats()
        m.gauge("rollout_cache.hits").set(rc["hits"])
        m.gauge("rollout_cache.misses").set(rc["misses"])
        from ..forecast.features import trace_count
        m.gauge("jit.retrace.total").set(trace_count())
        sched = self.scheduler.stats()
        m.gauge("scheduler.heap_entries").set(sched["heap_entries"])
        m.gauge("scheduler.tracked").set(sched["tracked"])
        m.gauge("scheduler.interned_bins").set(sched["interned_bins"])
        cached = getattr(self, "_fleet_ex", None)
        rt = cached[1].runtime if cached is not None else None
        if rt is not None:
            m.gauge("runtime.cold_loads").set(rt.cold_loads)
            m.gauge("runtime.warm_loads").set(rt.warm_loads)
            m.gauge("runtime.invalidations").set(rt.invalidations)
        if self.journal is not None:
            js = self.journal.stats()
            m.gauge("wal.records").set(js["records"])
            m.gauge("wal.segments").set(js["segments"])
            m.gauge("wal.snapshots").set(js["snapshots"])
            m.gauge("wal.bytes_written").set(js["bytes_written"])

    def snapshot(self) -> dict:
        """The unified observability snapshot: ``{"stats": <the exact
        dict stats() returns>, "metrics": <registry snapshot>,
        "trace": <tracer ring stats>}``. ``stats()`` is the
        backward-compatible view over this snapshot's ``"stats"`` key."""
        from ..obs.export import obs_snapshot
        self._mirror_metrics()
        return obs_snapshot(self.stats(), self.tracer, self.metrics)

    def stats(self) -> dict:
        st = self.store.stats()
        out = {**self.graph.stats(),
               "points": st["points"],
               "segments": st["segments"],
               "store_reads": st["reads"],
               "store_read_many": st["read_many"],
               "deployments": len(self.deployments),
               "deployments_by_flow": self.deployments.flow_counts(),
               "deployment_revision": self.deployments.revision,
               "model_versions": self.versions.count(),
               "forecasts": self.predictions.count(),
               "detection": self.detections.stats(),
               "scheduler": self.scheduler.stats()}
        sv = getattr(self, "_serverless_ex", None)
        if sv is not None:
            # per-invocation cold/warm-start + queue/execution latency
            # telemetry from the serverless monitor, plus elastic-pool /
            # chaos / storage sub-summaries when the executor was built
            # with those features
            out["serverless"] = sv.stats()
        if self.journal is not None:
            # WAL telemetry: records/segments/snapshots written, bytes,
            # group-commit overflow flushes (durability/journal.py)
            out["durability"] = self.journal.stats()
        return out

    def close(self) -> None:
        """Release long-lived execution resources: flush+close the
        durability journal (any buffered WAL records and the scheduler's
        undrained delta fsync BEFORE the storage backend — possibly an
        owned tempdir — is released), then the cached serverless
        executor's backend (spawned worker processes, owned storage
        buckets). Idempotent: double-close and ``__exit__`` after an
        explicit ``close()`` are no-ops; the in-memory stores stay
        usable."""
        j = getattr(self, "journal", None)
        if j is not None:
            delta = self.scheduler.drain_dirty()
            if delta is not None:
                j.append("sched", delta)
            j.close()
            self._detach_journal()     # journal=None: re-close is a no-op
        owned = getattr(self, "_durable_storage", None)
        if owned is not None:
            self._durable_storage = None
            owned.close()
        sv = getattr(self, "_serverless_ex", None)
        if sv is not None:
            self._serverless_ex = None
            sv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


MINUTE = 60.0
HOUR = 3600.0
DAY = 24 * HOUR
WEEK = 7 * DAY
__all__ = ["Castor", "Schedule", "ModelDeployment", "MINUTE", "HOUR",
           "DAY", "WEEK"]
