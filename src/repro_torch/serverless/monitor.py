"""Invocation telemetry (the Lithops monitor role, in-process).

Every invocation — including retries and speculative backups — lands one
record: which worker ran it, whether the container was cold or warm,
queue latency (enqueue -> worker pickup; on a cold process worker this
includes the container spawn, which is exactly what cold start means),
and execution latency. ``summary()`` aggregates what ``Castor.stats()``
surfaces: cold/warm counts, sticky-routing warm
reuse, aggregation factor actually achieved, latency percentiles.

Per-invocation records live in a bounded ring (``max_records`` deep, so
a million-invocation run cannot leak memory): once full, each new record
evicts the oldest and bumps ``dropped``. Percentile summaries therefore describe the most
*recent* window, which is also what ``recent_queue_p95`` — the
autoscaler's scale-out signal — wants; the running aggregates
(``invocations``/``cold_starts``/...) remain exact lifetime totals.

Each ``record()`` also lands in the global metrics registry
(``serverless.*`` counters + queue/exec latency histograms), so the
observability plane's Prometheus/JSON exports see invocation telemetry
without touching the ring.
"""
from __future__ import annotations

import threading
from collections import deque
from itertools import islice
from typing import Any, Dict, List

from ..obs.metrics import get_metrics


class InvocationMonitor:
    def __init__(self, max_records: int = 100_000):
        self.max_records = int(max_records)
        self._lock = threading.Lock()
        self.records: deque = deque(maxlen=self.max_records)
        self.dropped = 0                 # records evicted from the ring
        # running aggregates (exact even after the ring wraps)
        self.invocations = 0
        self.cold_starts = 0
        self.warm_starts = 0
        self.retries = 0                 # re-submissions after failure
        self.speculative = 0             # straggler backup copies
        self.jobs = 0
        self.failed_invocations = 0
        # registry mirrors, resolved once (zero lookups per record)
        m = get_metrics()
        self._m_invocations = m.counter("serverless.invocations")
        self._m_cold = m.counter("serverless.cold_starts")
        self._m_warm = m.counter("serverless.warm_starts")
        self._m_retries = m.counter("serverless.retries")
        self._m_speculative = m.counter("serverless.speculative")
        self._m_failed = m.counter("serverless.failed_invocations")
        self._m_jobs = m.counter("serverless.jobs")
        self._m_queue = m.histogram("serverless.queue_s")
        self._m_exec_cold = m.histogram("serverless.exec_s.cold")
        self._m_exec_warm = m.histogram("serverless.exec_s.warm")

    def record(self, *, payload, result=None, worker_id: str,
               error: str = "", retried: bool = False,
               speculative: bool = False) -> None:
        rec = {
            "invocation_id": payload.invocation_id,
            "worker": worker_id,
            "jobs": payload.n_jobs,
            "bins": payload.n_bins,
            "attempt": payload.attempt,
            "speculative": speculative,
        }
        if result is not None:
            rec.update(
                cold=result.cold_start,
                queue_s=max(0.0, result.started_at - payload.created_at),
                exec_s=max(0.0, result.finished_at - result.started_at),
                ok=all(o.ok for o in result.outcomes))
        else:
            rec.update(cold=False, queue_s=0.0, exec_s=0.0, ok=False,
                       error=error)
        with self._lock:
            self.invocations += 1
            self.jobs += payload.n_jobs
            self._m_invocations.inc()
            self._m_jobs.inc(payload.n_jobs)
            if retried:
                self.retries += 1
                self._m_retries.inc()
            if speculative:
                self.speculative += 1
                self._m_speculative.inc()
            if result is None:
                self.failed_invocations += 1
                self._m_failed.inc()
            elif result.cold_start:
                self.cold_starts += 1
                self._m_cold.inc()
                self._m_queue.observe(rec["queue_s"])
                self._m_exec_cold.observe(rec["exec_s"])
            else:
                self.warm_starts += 1
                self._m_warm.inc()
                self._m_queue.observe(rec["queue_s"])
                self._m_exec_warm.observe(rec["exec_s"])
            if len(self.records) == self.max_records:
                self.dropped += 1      # ring full: oldest record evicts
            self.records.append(rec)

    def _tail(self, window: int) -> List[Dict[str, Any]]:
        """Last ``window`` records (lock held by caller)."""
        n = len(self.records)
        if window >= n:
            return list(self.records)
        return list(islice(self.records, n - window, n))

    def recent_queue_p95(self, window: int = 64) -> float:
        """p95 queue latency (enqueue -> worker pickup) over the last
        ``window`` successful invocations — the autoscaler's scale-out
        signal (``serverless.autoscale``)."""
        with self._lock:
            recs = self._tail(window)
        return self._pctl([r["queue_s"] for r in recs if r.get("ok")], 0.95)

    @staticmethod
    def _pctl(xs: List[float], q: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            recs = list(self.records)
            out = {
                "invocations": self.invocations,
                "cold_starts": self.cold_starts,
                "warm_starts": self.warm_starts,
                "retries": self.retries,
                "speculative": self.speculative,
                "failed_invocations": self.failed_invocations,
                "jobs": self.jobs,
                "records_dropped": self.dropped,
            }
        # derived ratios come from the SNAPSHOT, not the live counters —
        # a concurrent record() between here and the with-block above
        # must not produce a torn summary
        out["warm_frac"] = (out["warm_starts"] / out["invocations"]
                            if out["invocations"] else 0.0)
        out["mean_aggregation"] = (out["jobs"] / out["invocations"]
                                   if out["invocations"] else 0.0)
        ok = [r for r in recs if r.get("ok")]
        warm = [r for r in ok if not r["cold"]]
        cold = [r for r in ok if r["cold"]]
        out["queue_s_p50"] = self._pctl([r["queue_s"] for r in ok], 0.5)
        out["queue_s_p95"] = self._pctl([r["queue_s"] for r in ok], 0.95)
        out["exec_s_p50"] = self._pctl([r["exec_s"] for r in ok], 0.5)
        out["cold_exec_s_mean"] = (sum(r["exec_s"] for r in cold) / len(cold)
                                   if cold else 0.0)
        out["warm_exec_s_mean"] = (sum(r["exec_s"] for r in warm) / len(warm)
                                   if warm else 0.0)
        workers: Dict[str, int] = {}
        for r in recs:
            workers[r["worker"]] = workers.get(r["worker"], 0) + 1
        out["per_worker"] = dict(sorted(workers.items()))
        return out
