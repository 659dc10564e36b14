"""The serverless invoker (paper §2 step 8: "deployed models are
automatically executed in parallel leveraging a serverless cloud
computing framework"; architecture adapted from the Lithops invoker).

Responsibilities, in the order they happen each phase:

* **Phase barrier.** All due TRAIN work completes before any SCORE
  invocation is submitted — a scoring action may consume a version
  trained this cycle on a *different* worker, so the barrier is global,
  not per-invocation (each backend worker only sees its own slice).
  ``submit()`` exposes the async single-phase surface underneath the
  barrier: it returns one ``ResponseFuture`` per invocation and streams
  each action's effects into the stores the moment it completes, so a
  consumer ``wait()``-ing with ``ANY_COMPLETED`` can read an
  early-finishing bin's forecasts while the slowest bin is still running.
* **Action aggregation.** Due jobs are binned exactly as the fleet
  executor bins them, and WHOLE bins are packed into invocations up to
  ``aggregation`` jobs per action (the paper groups its tens of
  thousands of modelling tasks into far fewer serverless actions). Bins
  are never split: a fleet bin is one megabatched computation whose f32
  numerics depend on the batch composition — splitting would break the
  bitwise inline == fleet contract.
* **Warm-container affinity + late-bound dispatch.** Each logical bin
  (``payload.affinity_key``: an interned int for deployment set + params,
  stable across polls and across train/score) routes stickily to the
  worker that last ran it, so
  that worker's ``FleetRuntime`` — device rings, compile caches,
  train->score param handoff — stays warm. Affinity follows success: a
  bin that completes on a different worker (retry, speculation) re-pins
  there. Planning only records a PREFERENCE; the actual worker is chosen
  at dispatch time from the live pool, which is what makes the pool
  elastic — an action queued behind a busy container can land on a
  worker the autoscaler provisioned after the phase was planned. With a
  fixed fleet (no autoscaler) dispatch waits for the preferred worker,
  preserving deterministic sticky routing.
* **Autoscaling.** With an ``AutoscalePolicy`` the invoker drives an
  ``Autoscaler`` from its wait loop: scale out while ready work is
  backlogged and the pool is saturated (or recent queue p95 exceeds
  target), reap containers idle past the TTL — and dispatch steals
  across workers instead of waiting on the preferred one.
* **Bounded in-flight concurrency + retries + stragglers.** At most
  ``max_in_flight`` invocations run concurrently; a failed invocation
  retries with jittered exponential backoff on a DIFFERENT worker, and a
  straggler (running ``straggler_factor``x the median of completed
  invocations) gets one speculative backup copy. All of this is safe
  because persistence (``ModelVersionStore``/``PredictionStore``) is
  idempotent on (deployment, occurrence stamp): at-least-once invocation
  yields exactly-once effects, duplicates no-op at the store.
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.executor import Executor, JobResult
from ..core.lineage import Forecast
from ..core.scheduler import Job, bin_jobs
from ..forecast.base import version_from_numpy
from ..obs.trace import get_tracer
from .autoscale import AutoscalePolicy, Autoscaler
from .backend import InlineBackend, InvocationBackend
from .futures import ResponseFuture
from .monitor import InvocationMonitor
from .payload import (ForecastBlob, InvocationPayload, InvocationResult,
                      JobRef, VersionRef, affinity_key)


class _Phase:
    """All mutable state of one phase in flight: the ready queue of
    not-yet-dispatched invocation copies, the backoff queue, the pool
    futures actually executing, and the exactly-once bookkeeping
    (attempts / in-flight copies / winners)."""

    def __init__(self, invocations: List[dict], results: List[JobResult]):
        self.results = results
        self.ready: List[dict] = []
        self.deferred: List[tuple] = []    # (ready_at, inv) backoff queue
        self.pending: Dict[object, dict] = {}   # pool future -> inv
        self.attempts: Dict[str, int] = {}      # iid -> copies created
        self.inflight: Dict[str, int] = {}      # iid -> copies not settled
        self.done_ids: set = set()
        self.durations: List[float] = []
        self.started: Dict[int, float] = {}     # token -> dispatch time
        self.backups: Dict[str, bool] = {}
        self.busy: Dict[str, int] = {}          # worker -> in-flight count
        self.span_done: set = set()   # iids whose pre-allocated invoke
        #                               span id has been recorded
        self.futures: Dict[str, ResponseFuture] = {
            inv["payload"].invocation_id:
                ResponseFuture(inv["payload"].invocation_id,
                               payload=inv["payload"])
            for inv in invocations}
        self.tokens = iter(range(1 << 30))


class ServerlessInvoker:
    def __init__(self, system, backend: InvocationBackend, *,
                 aggregation: int = 32, max_in_flight: int = 8,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 straggler_factor: float = 4.0, straggler_min_s: float = 2.0,
                 speculative: bool = True, seed: int = 0,
                 autoscale: Optional[AutoscalePolicy] = None,
                 monitor: Optional[InvocationMonitor] = None):
        self.system = system
        self.backend = backend
        self.aggregation = max(1, int(aggregation))
        self.max_in_flight = max(1, int(max_in_flight))
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_s = float(straggler_min_s)
        self.speculative = speculative
        self.monitor = monitor or InvocationMonitor()
        self.autoscaler = (Autoscaler(backend, autoscale, self.monitor)
                           if autoscale is not None else None)
        self._rng = random.Random(seed)
        self._affinity: Dict[int, str] = {}     # interned affinity_key -> worker
        self._rr = 0
        self._seq = 0

    # ------------------------------------------------ public entry
    def run(self, jobs: List[Job]) -> List[JobResult]:
        out: List[JobResult] = []
        trains = [j for j in jobs if j.task == "train"]
        detects = [j for j in jobs if j.task == "detect"]
        scores = [j for j in jobs if j.task not in ("train", "detect")]
        # global train->score->detect barriers: a scoring action may
        # consume a version trained this cycle on a different worker, and
        # a detection compares against a band scored this cycle
        tracer = get_tracer()
        for task, phase in (("train", trains), ("score", scores),
                            ("detect", detects)):
            if not phase:
                continue
            with tracer.span("serverless.phase", task=task,
                             jobs=len(phase)):
                out.extend(self._run_phase(phase))
        if self.autoscaler is not None:
            self.autoscaler.reap_idle()
        return out

    def submit(self, jobs: List[Job]) -> List[ResponseFuture]:
        """Async single-phase submission: one ``ResponseFuture`` per
        aggregated invocation, driven by a daemon thread. Each future
        completes AFTER the invoker has absorbed that action's effects,
        so a completed future's forecasts/versions are already queryable
        — the streaming surface ``futures.wait(..., ANY_COMPLETED)``
        consumes. Jobs that fail planning (score with no trained version)
        are marked failed at the scheduler and re-fire there; mixing
        task kinds in one submission is rejected because the
        train->score->detect barriers cannot be enforced
        asynchronously."""
        tasks = {j.task for j in jobs}
        if len(tasks) > 1:
            raise ValueError(
                "submit() is single-phase: jobs of different tasks "
                f"({sorted(tasks)}) cannot share one async submission "
                "(train->score->detect barriers); use run() or one "
                "submit() call per task")
        results: List[JobResult] = []
        invocations = self._plan(jobs, results)
        state = _Phase(invocations, results)
        state.ready.extend(self._enqueue_all(state, invocations))
        futures = [state.futures[inv["payload"].invocation_id]
                   for inv in invocations]
        t = threading.Thread(target=self._drive, args=(state,),
                             name="serverless-invoker-drive", daemon=True)
        t.start()
        return futures

    # ------------------------------------------------ planning
    def _plan(self, jobs: List[Job], results: List[JobResult]
              ) -> List[dict]:
        """Bins -> worker routing -> aggregated invocations. Also resolves
        score-phase model versions (a never-trained deployment fails ALONE
        here, mirroring FleetExecutor's partial-bin semantics) and records
        the invoker-store version numbers so shipped-back forecasts can be
        persisted with the invoker's lineage numbering."""
        jobs = sorted(jobs, key=lambda j: j.scheduled_at)
        routed: Dict[str, List[dict]] = {w: [] for w in
                                         self.backend.worker_ids()}
        workers = list(routed)
        for key, bjs in bin_jobs(jobs).items():
            resolved: Dict[Tuple[str, float], object] = {}
            bands: Dict[Tuple[str, float], object] = {}
            if key[2] == "detect":
                # a detection needs the banded forecast a live poller
                # would have had at its boundary; a context with no band
                # yet fails ALONE (mirrors FleetExecutor's partial bin)
                present = []
                for j in bjs:
                    fc = self.system.predictions.latest(
                        j.signal, j.entity, at=j.scheduled_at)
                    if fc is None or fc.lower is None:
                        self.system.scheduler.mark_failed(j)
                        results.append(JobResult(
                            j, False, 0.0,
                            error=f"no banded forecast for "
                                  f"{j.signal}@{j.entity}"))
                    else:
                        present.append(j)
                        bands[(j.deployment_name, j.scheduled_at)] = fc
                bjs = present
                if not bjs:
                    continue
            elif key[2] != "train":
                present = []
                for j in bjs:
                    mv = self.system.versions.get(j.deployment_name,
                                                  at=j.scheduled_at)
                    if mv is None:
                        self.system.scheduler.mark_failed(j)
                        results.append(JobResult(
                            j, False, 0.0,
                            error=f"no trained version for "
                                  f"{j.deployment_name}"))
                    else:
                        present.append(j)
                        resolved[(j.deployment_name, j.scheduled_at)] = mv
                bjs = present
                if not bjs:
                    continue
            ak = affinity_key(bjs)
            w = self._affinity.get(ak)
            if w is None or w not in routed:
                w = workers[self._rr % len(workers)]
                self._rr += 1
                self._affinity[ak] = w
            routed[w].append({"jobs": bjs, "ak": ak, "resolved": resolved,
                              "bands": bands})
        invocations: List[dict] = []
        tracer = get_tracer()
        # trace context of the enclosing phase/tick span: each invocation
        # gets a PRE-ALLOCATED invoke-span id that rides the payload, so
        # worker spans can parent under it before it is recorded (the
        # span itself is recorded at settle time, when both endpoints of
        # the dispatch->result interval are known)
        tctx = tracer.current() if tracer.enabled else None

        def cut(worker: str, bins: List[dict]) -> None:
            self._seq += 1
            jobs_ = [j for b in bins for j in b["jobs"]]
            resolved = {k: mv for b in bins
                        for k, mv in b["resolved"].items()}
            bands_ = {k: fc for b in bins for k, fc in b["bands"].items()}
            versions: Tuple[VersionRef, ...] = ()
            band_blobs: Tuple[ForecastBlob, ...] = ()
            if self.backend.wants_artifacts and resolved:
                versions = tuple(
                    VersionRef(deployment_name=name, version=mv.version,
                               trained_at=mv.trained_at,
                               model_object=mv.params)
                    for (name, _at), mv in resolved.items())
            if self.backend.wants_artifacts and bands_:
                # the banded forecasts a detect action compares against:
                # shipped as data so a share-nothing worker replays the
                # invoker's ``at=`` resolution bitwise
                band_blobs = tuple(
                    ForecastBlob(deployment_name=fc.deployment_name,
                                 signal=fc.signal, entity=fc.entity,
                                 created_at=fc.created_at, times=fc.times,
                                 values=fc.values,
                                 model_version=fc.model_version,
                                 rank=fc.rank, lower=fc.lower,
                                 upper=fc.upper)
                    for fc in bands_.values())
            span_id = trace_id = None
            trace = None
            if tracer.enabled:
                span_id = tracer.allocate_id()
                trace_id = (tctx["trace_id"] if tctx is not None
                            else tracer.new_trace_id())
                trace = {"trace_id": trace_id, "parent_id": span_id}
            payload = InvocationPayload(
                invocation_id=f"inv-{self._seq:06d}",
                jobs=tuple(JobRef.from_job(j) for j in jobs_),
                versions=versions, bands=band_blobs,
                created_at=time.time(), trace=trace)
            invocations.append({"payload": payload, "worker": worker,
                                "aks": [b["ak"] for b in bins],
                                "resolved": resolved,
                                "span_id": span_id, "trace_id": trace_id,
                                "parent_id": (tctx["parent_id"]
                                              if tctx is not None else 0)})

        for w, bins in routed.items():
            cur: List[dict] = []
            n = 0
            for b in bins:
                if cur and n + len(b["jobs"]) > self.aggregation:
                    cut(w, cur)
                    cur, n = [], 0
                cur.append(b)
                n += len(b["jobs"])
            if cur:
                cut(w, cur)
        return invocations

    # ------------------------------------------------ dispatch
    def _enqueue_all(self, state: _Phase,
                     invocations: List[dict]) -> List[dict]:
        for inv in invocations:
            iid = inv["payload"].invocation_id
            state.attempts[iid] = state.attempts.get(iid, 0) + 1
            state.inflight[iid] = state.inflight.get(iid, 0) + 1
        return list(invocations)

    def _enqueue(self, state: _Phase, inv: dict, *,
                 delay_s: float = 0.0) -> None:
        """Create one more copy of an invocation (initial, retry or
        backup). Attempt accounting happens HERE — a copy waiting out its
        backoff still counts against the budget and against in-flight
        copies, so a concurrently failing sibling can neither overspend
        retries nor declare final failure while a retry is pending."""
        iid = inv["payload"].invocation_id
        state.attempts[iid] = state.attempts.get(iid, 0) + 1
        state.inflight[iid] = state.inflight.get(iid, 0) + 1
        if delay_s > 0:
            state.deferred.append((time.perf_counter() + delay_s, inv))
        else:
            state.ready.append(inv)

    def _pick_worker(self, state: _Phase, inv: dict, live: List[str],
                     idle: List[str]) -> Optional[str]:
        """Late-bound routing: the planned worker if it is live and idle;
        with an autoscaler (or when the planned worker was reaped) any
        idle live worker — work-stealing is what lets a freshly
        provisioned container drain the backlog. With a fixed fleet,
        dispatch WAITS for the preferred worker instead, keeping sticky
        routing (and its warm FleetRuntime reuse) deterministic."""
        pref = inv.get("worker")
        if pref in idle:
            return pref
        if pref in live and self.autoscaler is None:
            return None
        cands = [w for w in idle if w != inv.get("avoid")] or idle
        pick = cands[self._rr % len(cands)]
        self._rr += 1
        return pick

    def _dispatch(self, state: _Phase, pool: ThreadPoolExecutor) -> None:
        """One forward pass over the ready queue. Dispatching only
        CONSUMES capacity (workers get busier, pending fills), so
        re-scanning after a dispatch can never unlock an earlier-stuck
        item — a single pass reaches the same fixed point as a restart
        loop without the O(ready^2) rescans a 10k-invocation agg=1
        sweep would otherwise pay on every settle."""
        live = self.backend.worker_ids()
        keep: List[dict] = []
        for k, inv in enumerate(state.ready):
            iid = inv["payload"].invocation_id
            if iid in state.done_ids:          # a sibling copy already won
                state.inflight[iid] -= 1
                continue
            fut = state.futures.get(iid)
            if fut is not None and fut.cancelled:
                state.inflight[iid] -= 1
                self._finalize_cancel(state, inv)
                continue
            idle = [w for w in live if state.busy.get(w, 0) == 0]
            if not idle or len(state.pending) >= self.max_in_flight:
                keep.extend(state.ready[k:])   # nothing can dispatch now
                break
            w = self._pick_worker(state, inv, live, idle)
            if w is None:
                keep.append(inv)               # stuck on a busy preferred
                continue                       # worker; later items may go
            token = next(state.tokens)
            tr = get_tracer()
            inv = {**inv, "worker": w, "token": token,
                   "t_disp": tr.clock() if tr.enabled else 0.0}
            state.busy[w] = state.busy.get(w, 0) + 1
            state.started[token] = time.perf_counter()
            if self.autoscaler is not None:
                self.autoscaler.note_dispatch(w)
            f = pool.submit(self.backend.invoke, inv["payload"], w)
            state.pending[f] = inv
        state.ready[:] = keep

    def _finalize_cancel(self, state: _Phase, inv: dict) -> None:
        """A cancelled invocation stops consuming budget: no more copies,
        jobs marked failed so the scheduler re-fires each occurrence at
        its own boundary. Late effects of a copy that already ran are
        absorbed by store idempotency."""
        iid = inv["payload"].invocation_id
        if iid in state.done_ids:
            return
        state.done_ids.add(iid)
        for ref in inv["payload"].jobs:
            job = ref.to_job()
            self.system.scheduler.mark_failed(job)
            state.results.append(JobResult(
                job, False, 0.0, attempts=state.attempts.get(iid, 0),
                error="invocation cancelled"))

    # ------------------------------------------------ execution
    def _run_phase(self, jobs: List[Job]) -> List[JobResult]:
        if not jobs:
            return []
        results: List[JobResult] = []
        invocations = self._plan(jobs, results)
        if not invocations:
            return results
        state = _Phase(invocations, results)
        state.ready.extend(self._enqueue_all(state, invocations))
        self._drive(state)
        return results

    def _other_worker(self, cur: str) -> str:
        workers = self.backend.worker_ids()
        if len(workers) <= 1:
            return cur
        pick = workers[self._rr % len(workers)]
        self._rr += 1
        if pick == cur:
            pick = workers[self._rr % len(workers)]
            self._rr += 1
        return pick

    def _drive(self, state: _Phase) -> None:
        with ThreadPoolExecutor(max_workers=self.max_in_flight) as pool:
            while state.ready or state.deferred or state.pending:
                if state.deferred:    # release retries whose backoff
                    now_d = time.perf_counter()         # elapsed
                    due = [d for d in state.deferred if d[0] <= now_d]
                    state.deferred = [d for d in state.deferred
                                      if d[0] > now_d]
                    for _, inv in due:
                        iid_d = inv["payload"].invocation_id
                        if iid_d in state.done_ids:
                            # a sibling copy won while this retry was
                            # backing off: drop it (and its in-flight
                            # claim) instead of re-running the action
                            state.inflight[iid_d] -= 1
                            continue
                        state.ready.append(inv)
                self._dispatch(state, pool)
                if self.autoscaler is not None:
                    self.autoscaler.observe(backlog=len(state.ready),
                                            busy=dict(state.busy))
                    if state.ready:    # a scale-out makes new slots idle
                        self._dispatch(state, pool)
                if not state.pending:
                    if state.deferred:  # all runnable work is backing off
                        time.sleep(max(0.0, min(
                            t for t, _ in state.deferred)
                            - time.perf_counter()))
                    elif state.ready:   # no live idle worker to take it
                        time.sleep(0.005)
                    continue
                timeout = self.straggler_min_s
                if self.autoscaler is not None and state.ready:
                    # keep the scale-out decision loop responsive while
                    # work is backlogged
                    timeout = min(timeout, 0.05)
                if state.deferred:
                    timeout = max(0.005, min(
                        timeout, min(t for t, _ in state.deferred)
                        - time.perf_counter()))
                done, _ = wait(list(state.pending), timeout=timeout,
                               return_when=FIRST_COMPLETED)
                for f in done:
                    self._settle(state, f)
                self._maybe_backup(state)

    def _trace_invoke(self, state: _Phase, inv: dict, *, ok: bool,
                      worker: str, error: str = "") -> None:
        """Record one ``serverless.invoke`` span per settled copy — the
        1:1 twin of ``monitor.record`` (span counts == invocation
        counts). The FIRST settled copy of an invocation claims the
        pre-allocated span id the payload's trace context points at, so
        worker spans stitch under it; later copies (retries, backups)
        record fresh sibling ids under the same phase span."""
        tracer = get_tracer()
        if not tracer.enabled:
            return
        payload = inv["payload"]
        iid = payload.invocation_id
        span_id = None
        if iid not in state.span_done and inv.get("span_id") is not None:
            state.span_done.add(iid)
            span_id = inv["span_id"]
        args = {"invocation_id": iid, "worker": worker, "ok": ok,
                "jobs": payload.n_jobs, "attempt": payload.attempt}
        if error:
            args["error"] = error
        tracer.record("serverless.invoke", inv.get("t_disp", 0.0),
                      tracer.clock(), span_id=span_id,
                      parent_id=inv.get("parent_id", 0) or 0,
                      trace_id=inv.get("trace_id"), args=args)

    def _settle(self, state: _Phase, f) -> None:
        inv = state.pending.pop(f)
        payload = inv["payload"]
        iid = payload.invocation_id
        state.inflight[iid] -= 1
        state.busy[inv["worker"]] = max(0, state.busy.get(inv["worker"], 1)
                                        - 1)
        if self.autoscaler is not None:
            self.autoscaler.note_done(inv["worker"])
        fut = state.futures.get(iid)
        try:
            result = f.result()
        except Exception as e:  # noqa: BLE001
            self.monitor.record(
                payload=payload, worker_id=inv["worker"],
                error=f"{type(e).__name__}: {e}",
                retried=inv.get("retried", False),
                speculative=inv.get("speculative", False))
            self._trace_invoke(state, inv, ok=False, worker=inv["worker"],
                               error=f"{type(e).__name__}: {e}")
            if iid in state.done_ids:
                return                # a sibling copy already won
            if fut is not None and fut.cancelled:
                self._finalize_cancel(state, inv)
                return
            if state.attempts[iid] <= self.max_retries:
                retry = dict(inv)
                retry["avoid"] = inv["worker"]
                retry["worker"] = self._other_worker(inv["worker"])
                retry["retried"] = True
                retry["payload"] = replace(
                    payload, attempt=state.attempts[iid] + 1,
                    created_at=time.time())
                delay = (self.backoff_base_s
                         * (2 ** (state.attempts[iid] - 1))
                         * (1.0 + self._rng.random()))
                self._enqueue(state, retry, delay_s=delay)
            elif state.inflight[iid] == 0:
                # every copy burned: the whole action fails, each job
                # re-fires at its own boundary
                state.done_ids.add(iid)
                for ref in payload.jobs:
                    job = ref.to_job()
                    self.system.scheduler.mark_failed(job)
                    state.results.append(JobResult(
                        job, False, 0.0, attempts=state.attempts[iid],
                        error=f"invocation failed: "
                              f"{type(e).__name__}: {e}"))
                if fut is not None:
                    fut._set_error(e)
            return
        self.monitor.record(
            payload=payload, result=result, worker_id=result.worker_id,
            retried=inv.get("retried", False),
            speculative=inv.get("speculative", False))
        self._trace_invoke(state, inv, ok=True, worker=result.worker_id)
        if iid in state.done_ids:
            return                    # speculation loser: effects already
        if fut is not None and fut.cancelled:   # deduped by stores
            self._finalize_cancel(state, inv)
            return
        state.done_ids.add(iid)
        if result.spans:
            # stitch the (process) worker's shipped spans under this
            # invocation's pre-allocated invoke span; re-based onto this
            # process's clock at the dispatch instant (worker and invoker
            # monotonic clocks are not comparable)
            get_tracer().absorb(list(result.spans),
                                t_base=inv.get("t_disp"))
        state.durations.append(result.finished_at - result.started_at)
        for ak in inv["aks"]:         # affinity follows success
            self._affinity[ak] = result.worker_id
        state.results.extend(self._absorb(inv, result,
                                          state.attempts[iid]))
        if fut is not None:           # effects are persisted BEFORE the
            fut._set_result(result)   # future completes: streaming reads
            # of a done future's forecasts/versions always hit the stores

    def _maybe_backup(self, state: _Phase) -> None:
        """Straggler resubmission (MapReduce-style backup copies).
        Pointless with a single worker: backends run one action per
        worker at a time, so a backup would just queue behind the very
        straggler it is meant to outrun."""
        if not self.speculative or not state.durations \
                or len(self.backend.worker_ids()) <= 1:
            return
        med = float(np.median(state.durations))
        thresh = max(self.straggler_min_s, self.straggler_factor * med)
        now = time.perf_counter()
        for f, inv in list(state.pending.items()):
            iid = inv["payload"].invocation_id
            t0 = state.started.get(inv["token"])
            if t0 is None or iid in state.done_ids \
                    or state.backups.get(iid) \
                    or state.attempts[iid] > self.max_retries \
                    or now - t0 <= thresh:
                continue
            state.backups[iid] = True
            backup = dict(inv)
            backup["avoid"] = inv["worker"]
            backup["worker"] = self._other_worker(inv["worker"])
            backup["speculative"] = True
            backup["payload"] = replace(inv["payload"],
                                        created_at=time.time())
            self._enqueue(state, backup)

    # ------------------------------------------------ absorption
    def _absorb(self, inv: dict, result: InvocationResult,
                n_attempts: int) -> List[JobResult]:
        """Turn one completed invocation into persisted effects +
        JobResults. Backends whose workers share the invoker's stores
        (inline) have already persisted; artifact-shipping backends
        (process) persist here — idempotently, so replayed or speculative
        duplicates of the same occurrence no-op."""
        if self.backend.wants_artifacts:
            # shipped-back versions arrive decoded as numpy: onto the
            # invoker's device, where they score like versions trained here
            for vr in result.versions:
                self.system.versions.save(
                    vr.deployment_name,
                    version_from_numpy(vr.model_object, self.system.device),
                    trained_at=vr.trained_at,
                    metadata={"serverless": True,
                              "worker": result.worker_id})
            fcs = []
            for fb in result.forecasts:
                mv = inv["resolved"].get((fb.deployment_name, fb.created_at))
                dep = self.system.deployments.get(fb.deployment_name)
                fcs.append(Forecast(
                    deployment_name=fb.deployment_name, signal=fb.signal,
                    entity=fb.entity, created_at=fb.created_at,
                    times=np.asarray(fb.times),
                    values=np.asarray(fb.values),
                    # the invoker's OWN lineage numbering, not the worker
                    # replica's (their histories can differ)
                    model_version=(mv.version if mv is not None
                                   else fb.model_version),
                    rank=dep.rank,
                    lower=(None if fb.lower is None
                           else np.asarray(fb.lower)),
                    upper=(None if fb.upper is None
                           else np.asarray(fb.upper))))
            if fcs:
                self.system.predictions.save_many(fcs)
            if result.detections:
                from ..flows.detection import DetectionRecord
                self.system.detections.save_many([
                    DetectionRecord(
                        deployment_name=db.deployment_name,
                        signal=db.signal, entity=db.entity,
                        scheduled_at=db.scheduled_at, score=db.score,
                        n_readings=db.n_readings,
                        n_anomalies=db.n_anomalies,
                        band_misses=db.band_misses,
                        model_version=db.model_version,
                        derived_signal=db.derived_signal)
                    for db in result.detections])
        out = []
        for o in result.outcomes:
            job = o.ref.to_job()
            if not o.ok:
                # inline workers marked the shared scheduler already
                # (idempotent set); process workers only marked their own
                self.system.scheduler.mark_failed(job)
            out.append(JobResult(job, o.ok, o.duration_s,
                                 attempts=max(o.attempts, n_attempts),
                                 error=o.error))
        return out


class ServerlessExecutor(Executor):
    """Executor-protocol facade: ``run(jobs) -> List[JobResult]`` like
    LocalPool/Fleet, but through the serverless invocation pipeline.
    Default backend is the deterministic in-process ``InlineBackend``
    (optionally storage-mediated and/or chaos-injected); pass a
    ``ProcessBackend`` for real OS-level containers. ``run_async`` is the
    futures surface; with an ``AutoscalePolicy`` the pool is elastic.
    Long-lived: keep ONE instance across polls so warm-container affinity
    pays (``Castor.serverless_executor()`` does this)."""

    def __init__(self, system, *, backend: Optional[InvocationBackend] = None,
                 n_workers: int = 4, storage=None, chaos=None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 monitor: Optional[InvocationMonitor] = None, **invoker_kw):
        if backend is None:
            backend = InlineBackend(system, n_workers=n_workers,
                                    storage=storage, chaos=chaos)
        elif storage is not None or chaos is not None:
            raise ValueError(
                "storage/chaos apply to the default InlineBackend; "
                "configure an explicit backend directly")
        self.backend = backend
        self.monitor = monitor or InvocationMonitor()
        self.invoker = ServerlessInvoker(system, self.backend,
                                         monitor=self.monitor,
                                         autoscale=autoscale, **invoker_kw)

    def run(self, jobs: List[Job]) -> List[JobResult]:
        return self.invoker.run(jobs)

    def run_async(self, jobs: List[Job]) -> List[ResponseFuture]:
        """Single-phase async submission; see ``ServerlessInvoker.submit``
        and ``serverless.futures.wait``."""
        return self.invoker.submit(jobs)

    def reap_idle(self) -> List[str]:
        """Reap idle-past-TTL containers now (autoscaled executors only;
        no-op otherwise). The invoker also reaps at the end of ``run``."""
        a = self.invoker.autoscaler
        return a.reap_idle() if a is not None else []

    def stats(self) -> dict:
        out = self.monitor.summary()
        out["workers"] = len(self.backend.worker_ids())
        if self.invoker.autoscaler is not None:
            out["autoscale"] = self.invoker.autoscaler.summary()
        chaos = getattr(self.backend, "chaos", None)
        if chaos is not None:
            out["chaos"] = chaos.summary()
        storage = getattr(self.backend, "storage", None)
        if storage is not None:
            out["storage"] = storage.stats()
        return out

    def close(self) -> None:
        self.backend.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
