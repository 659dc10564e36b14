"""The Castor system facade: wires the knowledge store, registry, deployments,
scheduler, executors and lineage into the paper's workflow (Fig. 1):

    (1) ingest -> (2) semantics -> (3/4) implement+publish -> (5/6) deploy ->
    (7) schedule -> (8/9) execute -> (10) persist forecasts.

``device`` (default ``"cuda"``) is where fleet scoring runs: the executor's
runtime state, the stacked model versions and the kernels all live there.
Asking for ``"cuda"`` without a card raises; the CPU runs only when asked
for, as the tests do.
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
        core/runtime.py) or "local" (the paper-faithful stateless pool,
        built per call)."""
        tracer = self.tracer
        with tracer.span("castor.tick", now=now, executor=executor):
            jobs = self.scheduler.poll(now)
            if not jobs:
                return []
            if executor == "fleet":
                ex = self.fleet_executor(max_parallel=max_parallel)
            elif executor == "local":
                ex = LocalPoolExecutor(self, max_parallel=max_parallel)
            else:
                raise ValueError(f"unknown executor {executor!r} "
                                 "(expected fleet | local)")
            return ex.run(jobs)

    def fleet_executor(self, *, max_parallel: int = 16) -> FleetExecutor:
        """The system's long-lived fleet executor (steady-state runtime
        state lives here); rebuilt only if the pool size changes."""
        cached = getattr(self, "_fleet_ex", None)
        if cached is None or cached[0] != max_parallel:
            ex = FleetExecutor(self, fallback=LocalPoolExecutor(
                self, max_parallel=max_parallel))
            self._fleet_ex = cached = (max_parallel, ex)
        return cached[1]

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
        return {**self.graph.stats(),
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


MINUTE = 60.0
HOUR = 3600.0
DAY = 24 * HOUR
WEEK = 7 * DAY
__all__ = ["Castor", "Schedule", "ModelDeployment", "MINUTE", "HOUR",
           "DAY", "WEEK"]
