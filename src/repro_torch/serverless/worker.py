"""Stateless-payload workers (the Lithops worker/handler split adapted).

A worker owns NOTHING the payload doesn't reference: it reconstructs its
slice of work from the stores alone (``JobRef.to_job`` + the system's
deployment/registry/series stores) and executes it through a private
``FleetExecutor``. What it DOES keep between invocations is warmth — its
``FleetRuntime`` (device rings, compile caches, train->score param
handoff) persists for the worker's lifetime, which is why the invoker's
sticky routing pays: the second invocation of a bin on the same worker is
an O(delta) warm poll, on a different worker a cold rebuild.

``Worker.execute`` is shared by both backends and is where execution-side
chaos injects: an injected *delay* stalls before execution (straggler),
an injected *kill* executes a strict prefix of the action's bins — their
effects persist — and then raises ``ChaosKill``, modelling a container
preempted mid-action. ``_process_worker_main`` is the long-lived loop a
spawned container runs; with a storage root it resolves payload KEYS
against the shared ``FilesystemStorage`` bucket and ships results back
the same way (JSON over the pipe otherwise).
"""
from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional

import numpy as np

from ..forecast.base import version_from_numpy
from ..kernels.fleet_mlp import ops as fleet_mlp_ops
from ..obs.trace import get_tracer
from .chaos import ChaosKill, ChaosPolicy
from .payload import (DetectionBlob, ForecastBlob, InvocationPayload,
                      InvocationResult, JobOutcome, JobRef, VersionRef)


class Worker:
    """One warm container: a private ``FleetExecutor`` (own FleetRuntime,
    own fallback pool) over a system handle. For the inline backend the
    system IS the invoker's; for the process backend it is the worker's
    own replica built from a factory at cold start."""

    def __init__(self, worker_id: str, system, *, collect_artifacts: bool,
                 max_parallel: int = 8):
        from ..core.executor import FleetExecutor, LocalPoolExecutor
        self.worker_id = worker_id
        self.system = system
        self.collect_artifacts = collect_artifacts
        self.executor = FleetExecutor(
            system, fallback=LocalPoolExecutor(system,
                                               max_parallel=max_parallel))
        self.invocations = 0

    def execute(self, payload: InvocationPayload,
                chaos: Optional[ChaosPolicy] = None) -> InvocationResult:
        # stitch this worker's spans under the invoker's trace: the
        # payload carries the invoker's (trace_id, invoke-span id); for
        # the inline backend the spans land directly in the shared
        # tracer, for the process backend they ship back on the result
        # (the span also names the device the action ran on and this
        # process's fleet_mlp launches so far: for a spawned worker, what
        # its own card ran)
        tracer = get_tracer()
        with tracer.adopt(payload.trace):
            with tracer.span("worker.execute",
                             invocation_id=payload.invocation_id,
                             worker=self.worker_id,
                             jobs=payload.n_jobs) as sp:
                try:
                    return self._execute(payload, chaos)
                finally:
                    sp.set(device=str(self.system.device),
                           fleet_mlp_launches=
                           fleet_mlp_ops.invocation_count())

    def _execute(self, payload: InvocationPayload,
                 chaos: Optional[ChaosPolicy] = None) -> InvocationResult:
        started = time.time()
        cold = self.invocations == 0
        self.invocations += 1
        # "download" the artifacts a scoring action needs: idempotent on
        # (model_id, trained_at), so re-delivery (retries, sticky re-use
        # after a local train of the same occurrence) is a no-op. They
        # arrive decoded as numpy and land on this system's device.
        for vr in payload.versions:
            self.system.versions.save(vr.deployment_name,
                                      version_from_numpy(vr.model_object,
                                                         self.system.device),
                                      trained_at=vr.trained_at,
                                      metadata={"delivered": True})
        # likewise the banded forecasts a detect action compares against:
        # idempotent on (deployment, created_at), so a replica that scored
        # the band itself (or a re-delivery) no-ops
        if payload.bands:
            from ..core.lineage import Forecast
            self.system.predictions.save_many([
                Forecast(deployment_name=fb.deployment_name,
                         signal=fb.signal, entity=fb.entity,
                         created_at=fb.created_at,
                         times=np.asarray(fb.times),
                         values=np.asarray(fb.values),
                         model_version=fb.model_version, rank=fb.rank,
                         lower=(None if fb.lower is None
                                else np.asarray(fb.lower)),
                         upper=(None if fb.upper is None
                                else np.asarray(fb.upper)))
                for fb in payload.bands])
        jobs = [r.to_job() for r in payload.jobs]
        if chaos is not None:
            chaos.maybe_delay(payload)
            kill_after = chaos.kill_point(payload)
            if kill_after is not None:
                # execute a strict PREFIX of the action's bins, persist
                # their effects, then die: the retry re-runs the whole
                # action and the persisted prefix must no-op at the
                # idempotent stores (the exactly-once invariant's
                # hardest case)
                groups: Dict[tuple, List] = {}
                for j in jobs:
                    groups.setdefault(j.bin_key, []).append(j)
                for bin_jobs_ in list(groups.values())[:kill_after]:
                    self.executor.run(bin_jobs_)
                raise ChaosKill(
                    f"chaos: {self.worker_id} killed after "
                    f"{kill_after}/{len(groups)} bins of "
                    f"{payload.invocation_id}")
        results = self.executor.run(jobs)
        outcomes = tuple(
            JobOutcome(ref=JobRef.from_job(r.job), ok=r.ok,
                       duration_s=r.duration_s, error=r.error,
                       attempts=r.attempts)
            for r in results)
        versions: List[VersionRef] = []
        forecasts: List[ForecastBlob] = []
        detections: List[DetectionBlob] = []
        if self.collect_artifacts:
            for r in results:
                if not r.ok:
                    continue
                if r.job.task == "train":
                    mv = self.system.versions.get(r.job.deployment_name,
                                                  at=r.job.scheduled_at)
                    versions.append(VersionRef(
                        deployment_name=r.job.deployment_name,
                        version=mv.version, trained_at=mv.trained_at,
                        model_object=mv.params))
                elif r.job.task == "detect":
                    for dr in reversed(self.system.detections.history(
                            r.job.deployment_name)):
                        if dr.scheduled_at == r.job.scheduled_at:
                            detections.append(DetectionBlob(
                                deployment_name=dr.deployment_name,
                                signal=dr.signal, entity=dr.entity,
                                scheduled_at=dr.scheduled_at,
                                score=dr.score, n_readings=dr.n_readings,
                                n_anomalies=dr.n_anomalies,
                                band_misses=dr.band_misses,
                                model_version=dr.model_version,
                                derived_signal=dr.derived_signal))
                            break
                else:
                    # newest-first: the forecast for this occurrence was
                    # just appended at the tail, so a long-lived warm
                    # worker's ship-back stays O(1) per job instead of
                    # rescanning its whole replica history every poll
                    for fc in reversed(self.system.predictions.history(
                            r.job.deployment_name)):
                        if fc.created_at == r.job.scheduled_at:
                            forecasts.append(ForecastBlob(
                                deployment_name=fc.deployment_name,
                                signal=fc.signal, entity=fc.entity,
                                created_at=fc.created_at, times=fc.times,
                                values=fc.values,
                                model_version=fc.model_version,
                                rank=fc.rank, lower=fc.lower,
                                upper=fc.upper))
                            break
        return InvocationResult(
            invocation_id=payload.invocation_id, worker_id=self.worker_id,
            cold_start=cold, started_at=started, finished_at=time.time(),
            outcomes=outcomes, versions=tuple(versions),
            forecasts=tuple(forecasts), detections=tuple(detections))


def _process_worker_main(task_q, result_q, factory, worker_id: str,
                         env: Optional[Dict[str, str]] = None,
                         storage_root: Optional[str] = None) -> None:
    """Entry point of a spawned worker container. ``factory`` is a
    picklable zero-arg callable reconstructing the worker's system replica
    (its 'connection to shared storage'): spawned processes share no
    memory, so determinism of the factory is what stands in for a real
    shared backend. ``storage_root`` names the shared filesystem bucket
    for storage-mediated transport (payload keys in, result keys out);
    without it, raw JSON strings cross the pipe. ``None`` is the shutdown
    sentinel either way. A replica on ``"cuda"`` opens this process's own
    CUDA context; a factory that cannot build it (no card) is a
    cold-start failure, reported as such."""
    for k, v in (env or {}).items():
        os.environ[k] = v
    try:
        from .storage import (FilesystemStorage, get_payload, put_result)
        storage = (FilesystemStorage(storage_root)
                   if storage_root is not None else None)
        system = factory()
        worker = Worker(worker_id, system, collect_artifacts=True)
        result_q.put(("ready", worker_id))
    except BaseException as e:  # noqa: BLE001 — report cold-start failure
        result_q.put(("fatal", f"{type(e).__name__}: {e}"))
        return
    while True:
        msg = task_q.get()
        if msg is None:
            return
        iid = ""
        try:
            if isinstance(msg, tuple) and msg[0] == "ref":
                payload = get_payload(storage, msg[1])
            else:
                payload = InvocationPayload.from_json(msg)
            iid = payload.invocation_id
            # ship the spans this invocation finished back with the
            # result: the invoker's tracer absorbs them (re-iding onto
            # its own counter) so the cross-process trace stitches
            tracer = get_tracer()
            mark = tracer.mark()
            result = worker.execute(payload)
            spans = tracer.export_since(mark)
            if spans:
                result = replace(result, spans=tuple(spans))
            if storage is not None:
                key = put_result(storage, result, payload.attempt)
                result_q.put(("result-ref", iid, key))
            else:
                result_q.put(("result", iid, result.to_json()))
        except BaseException as e:  # noqa: BLE001 — ship the error back,
            # tagged with the invocation it belongs to so the backend can
            # never attribute a stale predecessor's error to a later call
            result_q.put(("error", iid, f"{type(e).__name__}: {e}"))
