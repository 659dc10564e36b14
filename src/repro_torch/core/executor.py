"""Model execution engines (paper §2 + §4.3).

Every engine implements one protocol — ``run(jobs) -> List[JobResult]``
(see ``Executor`` below) — with identical semantics: train jobs phase
before score jobs, failures are per job (``scheduler.mark_failed`` gives
at-least-once per occurrence), and all persistence goes through the
idempotent ``ModelVersionStore``/``PredictionStore``, so executors are
interchangeable behind ``Castor.tick(executor=...)``.

Two engines live here:

* ``LocalPoolExecutor`` — paper-faithful serverless semantics: each job is an
  independent unit on a bounded worker pool (the paper's 10..200 parallel
  containers), with retries, job timeout, and MapReduce-style speculative
  re-dispatch of stragglers. This is what the Table-3 scalability benchmark
  sweeps.

* ``FleetExecutor`` — the accelerator-native adaptation: due jobs are
  binned by (implementation, version, task, params, scheduled_at) and each
  bin executes as ONE megabatched computation on the system's device via
  the implementation's ``fleet_train`` / ``fleet_score`` hooks (batched
  tensors, the hand-written kernels under the hood). Implementations
  without fleet hooks fall back to the pool. Train bins always phase before score bins, and a score
  bin containing never-trained deployments fails only those jobs.

Data path: a fleet bin fetches ALL of its series history with a single
``store.read_many`` call (via ``ForecastModelBase.fleet_load``) against the
compacting columnar ``TimeSeriesStore``, instead of N per-instance
``read()``s; ``last_bin_stats`` records the observed ``read_many_calls`` /
``single_reads`` per bin so tests and benchmarks can assert the batching.

Observational-equivalence guarantee: for the same due jobs, the two
executors persist the same model versions and forecasts (up to per-model
training stochasticity with identical seeds) — ``fleet_load`` sets each
instance's ``_loaded`` to exactly what ``load()`` computes, the batched
store read returns the same points as N single reads, and both paths write
through the same ``ModelVersionStore`` / ``PredictionStore``. Choosing an
executor changes speed, never results.
"""
from __future__ import annotations

import queue
import threading
import time
from operator import attrgetter
import traceback
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer
from .lineage import Forecast
from .registry import ModelInterface
from .scheduler import Job, bin_jobs

#: C-speed sort key — a python lambda per job is measurable at fleet width
_BY_TIME = attrgetter("scheduled_at")


@dataclass
class JobResult:
    job: Job
    ok: bool
    duration_s: float
    attempts: int = 1
    error: str = ""
    output: Any = None
    speculative_win: bool = False   # a backup copy finished first


class Executor:
    """The executor protocol every engine satisfies (LocalPool, Fleet,
    Serverless): execute due jobs, persist effects idempotently, phase
    trains before scores, mark failures for at-least-once re-fire, and
    return one ``JobResult`` per job (order not contractual)."""

    def run(self, jobs: List[Job]) -> List[JobResult]:
        raise NotImplementedError


class _ExecBase(Executor):
    def __init__(self, system):
        self.system = system

    # ------------- single-job execution (shared) -------------
    _UNSET = object()

    def _instantiate(self, job: Job, latest=_UNSET,
                     cls=None) -> ModelInterface:
        """``latest``/``cls`` let callers that already resolved the model
        version or implementation class (the fleet bin path — shared
        across the whole bin) skip per-job registry/store lookups; the
        instance's ``model_version`` attribute is informational."""
        if cls is None:
            cls = self.system.registry.get(job.package, job.version)
        ctx = self.system.graph.context(job.signal, job.entity)
        dep = self.system.deployments.get(job.deployment_name)
        if latest is _ExecBase._UNSET:
            latest = self.system.versions.get(job.deployment_name)
        up = dict(dep.user_params)
        # execution-time parameter: the poll's timestamp must ALWAYS win —
        # a stray "now" in a deployment's user_params would otherwise pin
        # every future job to that stale instant
        up["now"] = job.scheduled_at
        return cls(context=ctx, task=job.task, model_id=job.deployment_name,
                   model_version=latest.version if latest else None,
                   user_params=up, system=self.system)

    def _run_one(self, job: Job) -> Any:
        if job.task == "detect":
            # compare live readings against the band a LIVE poller would
            # have had at this boundary (same at= replay semantics as
            # scoring below); the detector persists through the idempotent
            # DetectionStore, so duplicate executions stay exactly-once
            fc = self.system.predictions.latest(job.signal, job.entity,
                                                at=job.scheduled_at)
            if fc is None or fc.lower is None:
                raise RuntimeError(
                    f"no banded forecast for {job.signal}@{job.entity}")
            inst = self._instantiate(job, latest=None)
            rec = inst.detect(fc)
            self.system.detections.save(rec)
            return {"detected": True, "score": rec.score}
        inst = self._instantiate(job)
        if job.task == "train":
            t0 = time.perf_counter()
            model_obj = inst.train()
            dt = time.perf_counter() - t0
            self.system.versions.save(
                job.deployment_name, model_obj, trained_at=job.scheduled_at,
                metadata={"train_seconds": dt, "signal": job.signal,
                          "entity": job.entity, "package": str(job.package)})
            return {"trained": True}
        # score with the version a LIVE poller would have had at the job's
        # boundary — catch-up occurrences must not leak later-trained models
        latest = self.system.versions.get(job.deployment_name,
                                          at=job.scheduled_at)
        if latest is None:
            raise RuntimeError(f"no trained version for {job.deployment_name}")
        res = inst.score(latest.params)
        # forecasters return (times, values, lower, upper); third-party
        # 2-tuple implementations persist band-less forecasts
        times, values = res[0], res[1]
        lower, upper = (res[2], res[3]) if len(res) > 2 else (None, None)
        dep = self.system.deployments.get(job.deployment_name)
        self.system.predictions.save(Forecast(
            deployment_name=job.deployment_name, signal=job.signal,
            entity=job.entity, created_at=job.scheduled_at,
            times=np.asarray(times), values=np.asarray(values),
            model_version=latest.version, rank=dep.rank,
            lower=None if lower is None else np.asarray(lower),
            upper=None if upper is None else np.asarray(upper)))
        return {"scored": True, "points": len(times)}


class LocalPoolExecutor(_ExecBase):
    """Paper-faithful parallel job execution on a bounded pool."""

    def __init__(self, system, *, max_parallel: int = 16, max_retries: int = 2,
                 straggler_factor: float = 3.0, straggler_min_s: float = 0.5,
                 speculative: bool = True):
        super().__init__(system)
        self.max_parallel = max_parallel
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.speculative = speculative

    def run(self, jobs: List[Job]) -> List[JobResult]:
        """Dependency phases: all due TRAIN jobs complete before SCORE jobs
        start (a scoring job may consume the version trained this cycle),
        and DETECT jobs run last (a detection may consume the band scored
        this cycle)."""
        trains = [j for j in jobs if j.task == "train"]
        detects = [j for j in jobs if j.task == "detect"]
        scores = [j for j in jobs if j.task not in ("train", "detect")]
        out: List[JobResult] = []
        for phase in (trains, scores, detects):
            out.extend(self._run_phase(phase))
        return out

    def _run_phase(self, jobs: List[Job]) -> List[JobResult]:
        if not jobs:
            return []
        with get_tracer().span("exec.pool", task=jobs[0].task,
                               jobs=len(jobs)):
            return self._run_phase_inner(jobs)

    def _run_phase_inner(self, jobs: List[Job]) -> List[JobResult]:
        results: Dict[int, JobResult] = {}
        durations: List[float] = []

        def attempt(job: Job) -> JobResult:
            t0 = time.perf_counter()
            try:
                out = self._run_one(job)
                return JobResult(job, True, time.perf_counter() - t0,
                                 output=out)
            except Exception as e:  # noqa: BLE001
                return JobResult(job, False, time.perf_counter() - t0,
                                 error=f"{type(e).__name__}: {e}")

        with ThreadPoolExecutor(max_workers=self.max_parallel) as pool:
            pending: Dict[Future, Tuple[Job, int, float]] = {}
            backups: Dict[int, Future] = {}
            inflight: Dict[int, int] = {}    # job idx -> live copies
            attempts: Dict[int, int] = {}    # job idx -> copies EVER submitted
            # the retry budget is per JOB, not per copy chain: a job may run
            # at most 1 + max_retries times total, and a speculative backup
            # consumes one attempt from that same budget — before, the
            # backup restarted the count and a job could burn the budget
            # twice over
            for i, job in enumerate(jobs):
                f = pool.submit(attempt, job)
                pending[f] = (job, i, time.perf_counter())
                inflight[i] = 1
                attempts[i] = 1

            while pending:
                done, _ = wait(list(pending), timeout=self.straggler_min_s,
                               return_when=FIRST_COMPLETED)
                now = time.perf_counter()
                for f in done:
                    job, idx, t0 = pending.pop(f)
                    inflight[idx] -= 1
                    res = f.result()
                    if idx in results:      # a copy already finished
                        continue
                    res.attempts = attempts[idx]
                    if res.ok:
                        # speculative_win only when the winning future IS
                        # the backup copy, not merely when one exists
                        res.speculative_win = backups.get(idx) is f
                        results[idx] = res
                        durations.append(res.duration_s)
                    elif attempts[idx] <= self.max_retries:
                        nf = pool.submit(attempt, job)
                        attempts[idx] += 1
                        pending[nf] = (job, idx, now)
                        inflight[idx] += 1
                    elif inflight[idx] == 0:
                        # a job fails only once NO copy of it remains in
                        # flight — a backup that dies must not discard a
                        # still-running primary's success (which would
                        # wrongly re-fire the job next poll)
                        results[idx] = res
                        self.system.scheduler.mark_failed(job)
                # speculative re-dispatch of stragglers (MapReduce-style)
                if self.speculative and durations:
                    med = float(np.median(durations))
                    thresh = max(self.straggler_min_s, self.straggler_factor * med)
                    for f, (job, idx, t0) in list(pending.items()):
                        if idx not in backups and now - t0 > thresh \
                                and attempts[idx] <= self.max_retries:
                            bf = pool.submit(attempt, job)
                            attempts[idx] += 1
                            backups[idx] = bf
                            pending[bf] = (job, idx, now)
                            inflight[idx] += 1
        return [results[i] for i in sorted(results)]


class FleetExecutor(_ExecBase):
    """Megabatched execution: one computation per job bin.

    Steady state: the executor owns a persistent ``FleetRuntime``
    (core/runtime.py) that keeps each bin's feature state device-resident
    across polls — a warm poll costs O(delta), not O(history). Per-bin
    telemetry (``runtime``/``cache_hit``/``delta_rows``/``retraces``/
    rollout-cache hits+misses) lands in ``last_bin_stats``; opt out per
    deployment with ``user_params["runtime"] = "off"`` or executor-wide
    with ``runtime="off"``.

    One card: a bin runs whole on the system's device. Sharding a bin's
    instance axis across cards is not ported; the per-bin telemetry keys
    (``sharded``, ``mesh_devices``, ``pad``) stay and read one card.
    """

    def __init__(self, system, *, fallback: Optional[LocalPoolExecutor] = None,
                 runtime: str = "auto"):
        super().__init__(system)
        self.fallback = fallback or LocalPoolExecutor(system, max_parallel=8)
        if runtime == "off":
            self.runtime = None
        else:
            from .runtime import FleetRuntime
            self.runtime = FleetRuntime(system)
        self.last_bin_stats: List[dict] = []
        # detect-bin instance cache: detector instances are pure wiring
        # (context + params + system handle, no trained state), identical
        # from one minutely boundary to the next — rebuild only when the
        # deployment store mutates (keyed on its revision)
        self._detect_instances: dict = {}
        # detect-bin band cache: resolved bands per bin, invalidated by
        # PredictionStore.mutations / max_created (see _run_bin)
        self._detect_bands: dict = {}

    def run(self, jobs: List[Job]) -> List[JobResult]:
        """Phase ordering is the executor's responsibility, not the
        caller's: all TRAIN bins complete before any SCORE bin starts (a
        score bin may consume a version trained this cycle), matching
        LocalPoolExecutor.run."""
        out: List[JobResult] = []
        self.last_bin_stats = []
        # single-pass phase partition (three filter scans over a fleet-wide
        # poll were measurable at minutely-detection width)
        trains: List[Job] = []
        detects: List[Job] = []
        scores: List[Job] = []
        t_append, d_append, s_append = (trains.append, detects.append,
                                        scores.append)
        for j in jobs:
            task = j.task
            if task == "detect":
                d_append(j)
            elif task == "train":
                t_append(j)
            else:
                s_append(j)
        tracer = get_tracer()
        for task, phase in (("train", trains), ("score", scores),
                            ("detect", detects)):
            if not phase:
                continue
            # chronological bins regardless of caller order: catch-up
            # occurrences of one deployment must train/score oldest first
            phase.sort(key=_BY_TIME)
            with tracer.span("exec.phase." + task, jobs=len(phase)):
                fleet_bins: List[Tuple[tuple, List[Job]]] = []
                pool_jobs: List[Job] = []
                for key, bin_jobs_ in bin_jobs(phase).items():
                    cls = self.system.registry.get(key[0], key[1])
                    if getattr(cls, "SUPPORTS_FLEET", False):
                        fleet_bins.append((key, bin_jobs_))
                    else:
                        # non-fleet jobs pool into ONE fallback run per
                        # phase: scheduled_at fragments their bins, and
                        # the pool — unlike a megabatch — has no
                        # shared-time-axis reason to run those fragments
                        # sequentially
                        pool_jobs.extend(bin_jobs_)
                if pool_jobs:
                    out.extend(self.fallback.run(pool_jobs))
                for key, bin_jobs_ in fleet_bins:
                    with tracer.span("exec.bin",
                                     bin_id=bin_jobs_[0].bin_id,
                                     jobs=len(bin_jobs_)):
                        out.extend(self._run_bin(key, bin_jobs_))
        return out

    def _bin_mesh(self, bin_jobs_: List[Job]):
        """Fleet mesh for one bin: None, since a bin runs on one card."""
        return None

    def _fail(self, job: Job, dt: float, err: str) -> JobResult:
        self.system.scheduler.mark_failed(job)
        return JobResult(job, False, dt, error=err)

    def _run_bin(self, key, bin_jobs_: List[Job]) -> List[JobResult]:
        cls = self.system.registry.get(key[0], key[1])
        out: List[JobResult] = []
        t0 = time.perf_counter()
        store = getattr(self.system, "store", None)
        rm0 = getattr(store, "read_many_count", 0)
        r0 = getattr(store, "read_count", 0)
        task = key[2]
        latests: List = []
        bands: List = []
        if task == "detect":
            # a detection compares against the band a LIVE poller would
            # have had at its boundary (predictions.latest honors rank and
            # at=, the same replay semantics scoring uses for versions); a
            # context with no banded forecast yet fails ALONE, the rest of
            # the bin detects
            preds = self.system.predictions
            at = float(bin_jobs_[0].scheduled_at)
            bkey = (key[0], key[1],
                    tuple(j.deployment_name for j in bin_jobs_))
            # band cache across minutely polls: the resolved bands can
            # only change when a forecast lands (mutations moves) or when
            # a later ``at`` admits an already-stored forecast — excluded
            # by max_created <= cached_at <= at
            cached = self._detect_bands.get(bkey)
            if cached is not None and cached[0] == preds.mutations \
                    and preds.max_created <= cached[1] <= at:
                bands = cached[2]
            else:
                n_bin = len(bin_jobs_)
                present = []
                for j in bin_jobs_:
                    fc = preds.latest(j.signal, j.entity,
                                      at=j.scheduled_at)
                    if fc is None or fc.lower is None:
                        out.append(self._fail(
                            j, 0.0,
                            f"no banded forecast for {j.signal}"
                            f"@{j.entity}"))
                    else:
                        present.append(j)
                        bands.append(fc)
                bin_jobs_ = present
                if not bin_jobs_:
                    return out
                if len(present) == n_bin:       # full bin resolved: the
                    if len(self._detect_bands) >= 8:    # bkey names match
                        self._detect_bands.clear()
                    self._detect_bands[bkey] = (preds.mutations, at, bands)
        elif task != "train":
            # a deployment that was never trained fails ALONE: exclude it
            # from the megabatch, score the rest — one cold model must not
            # poison the whole bin (at-least-once still holds per job).
            # at=scheduled_at: a catch-up bin scores with the versions a
            # live poller would have had at that boundary
            present: List[Job] = []
            for j in bin_jobs_:
                mv = self.system.versions.get(j.deployment_name,
                                              at=j.scheduled_at)
                if mv is None:
                    out.append(self._fail(
                        j, 0.0, f"no trained version for {j.deployment_name}"))
                else:
                    present.append(j)
                    latests.append(mv)
            bin_jobs_ = present
            if not bin_jobs_:
                return out
        # detection is a host-side store compare, nothing to shard
        mesh = None if task == "detect" else self._bin_mesh(bin_jobs_)
        ndev = len(mesh.devices.flat) if mesh is not None else 1
        pad = (-len(bin_jobs_)) % ndev
        if task == "train":
            instances = [self._instantiate(j, cls=cls) for j in bin_jobs_]
        elif task == "detect":
            ikey = bkey if len(bin_jobs_) == len(bkey[2]) else \
                (key[0], key[1],
                 tuple(j.deployment_name for j in bin_jobs_))
            rev = self.system.deployments.revision
            cached = self._detect_instances.get(ikey)
            if cached is not None and cached[0] == rev:
                _, instances, detect_ts_ids, detect_names = cached
            else:
                instances = [self._instantiate(j, latest=None, cls=cls)
                             for j in bin_jobs_]
                detect_ts_ids = [i.context.ts_id for i in instances]
                detect_names = ([i.model_id for i in instances],
                                [i.context.signal.name for i in instances],
                                [i.context.entity.name for i in instances])
                if len(self._detect_instances) >= 8:    # stale-rev bins
                    self._detect_instances.clear()
                self._detect_instances[ikey] = (rev, instances,
                                                detect_ts_ids, detect_names)
        else:       # versions already resolved above: no second lookup
            instances = [self._instantiate(j, latest=mv, cls=cls)
                         for j, mv in zip(bin_jobs_, latests)]
        from ..forecast.base import rollout_cache_stats
        from ..forecast.features import trace_count
        kw = {"mesh": mesh}
        if self.runtime is not None and getattr(cls, "SUPPORTS_RUNTIME",
                                                False):
            kw["runtime"] = self.runtime
        tr0, rc0 = trace_count(), rollout_cache_stats()
        dr0 = getattr(store, "delta_read_count", 0)
        try:
            if task == "train":
                model_objs = cls.fleet_train(instances, **kw)
                for j, mo in zip(bin_jobs_, model_objs):
                    self.system.versions.save(
                        j.deployment_name, mo, trained_at=j.scheduled_at,
                        metadata={"fleet": True, "signal": j.signal,
                                  "entity": j.entity})
            elif task == "detect":
                # ONE vectorized band-compare for the whole bin (one
                # read_many, no per-sensor python loop) through the
                # idempotent DetectionStore — exactly-once per occurrence
                records = cls.fleet_detect(
                    instances, bands,
                    now=float(bin_jobs_[0].scheduled_at),
                    ts_ids=detect_ts_ids, names=detect_names)
                self.system.detections.save_many(records)
            else:
                preds = cls.fleet_score(instances,
                                        [l.params for l in latests],
                                        **kw)
                fcs = []
                for j, l, p in zip(bin_jobs_, latests, preds):
                    times, values = p[0], p[1]
                    lower, upper = (p[2], p[3]) if len(p) > 2 else (None,
                                                                    None)
                    fcs.append(Forecast(
                        deployment_name=j.deployment_name, signal=j.signal,
                        entity=j.entity, created_at=j.scheduled_at,
                        times=times if isinstance(times, np.ndarray)
                        else np.asarray(times),
                        values=values if isinstance(values, np.ndarray)
                        else np.asarray(values),
                        model_version=l.version,
                        rank=self.system.deployments.get(
                            j.deployment_name).rank,
                        lower=None if lower is None else np.asarray(lower),
                        upper=None if upper is None else np.asarray(upper)))
                self.system.predictions.save_many(fcs)
            dt = time.perf_counter() - t0
            per = dt / max(len(bin_jobs_), 1)
            # dataclass __init__ per job is measurable at fleet width:
            # stamp a shared field template and install per-job dicts
            tmpl = {"job": None, "ok": True, "duration_s": per,
                    "attempts": 1, "error": "", "output": None,
                    "speculative_win": False}
            new = JobResult.__new__
            for j in bin_jobs_:
                r = new(JobResult)
                r.__dict__ = dict(tmpl, job=j)
                out.append(r)
            rc1 = rollout_cache_stats()
            stats = {"bin": str(key), "bin_id": bin_jobs_[0].bin_id,
                     "jobs": len(bin_jobs_), "seconds": dt,
                     "read_many_calls":
                         getattr(store, "read_many_count", 0) - rm0,
                     "single_reads": getattr(store, "read_count", 0) - r0,
                     "delta_reads":
                         getattr(store, "delta_read_count", 0) - dr0,
                     "sharded": mesh is not None, "mesh_devices": ndev,
                     "pad": pad, "dispatches": 1,
                     "retraces": trace_count() - tr0,
                     "rollout_cache_hits": rc1["hits"] - rc0["hits"],
                     "rollout_cache_misses": rc1["misses"] - rc0["misses"],
                     "runtime": "off", "cache_hit": False, "delta_rows": 0}
            if self.runtime is not None:
                stats.update(self.runtime.pop_stats())
            self.last_bin_stats.append(stats)
            # absorb the bin's telemetry into the metrics registry (once
            # per bin — off the per-job hot path)
            m = get_metrics()
            m.counter("exec.bins").inc()
            m.counter("exec.jobs").inc(stats["jobs"])
            m.histogram("exec.bin_seconds").observe(dt)
            m.counter("exec.retraces").inc(stats["retraces"])
            m.counter("exec.rollout_cache_hits").inc(
                stats["rollout_cache_hits"])
            m.counter("exec.rollout_cache_misses").inc(
                stats["rollout_cache_misses"])
            if stats["cache_hit"]:
                m.counter("runtime.cache_hits").inc()
            if stats["delta_rows"]:
                m.counter("runtime.delta_rows").inc(stats["delta_rows"])
        except Exception as e:  # noqa: BLE001
            dt = time.perf_counter() - t0
            err = f"{type(e).__name__}: {e}"
            if self.runtime is not None:
                self.runtime.pop_stats()        # don't leak into next bin
            out.extend(self._fail(j, dt / len(bin_jobs_), err)
                       for j in bin_jobs_)
        return out
