"""Telemetry-driven autoscaling of the warm-container pool.

The invoker's backends are elastic (``add_worker``/``remove_worker``);
the ``Autoscaler`` decides WHEN, driven by the same monitor telemetry
``Castor.stats()`` surfaces:

* **Scale out** while dispatchable work is backlogged and either every
  live container is busy or the recent p95 queue latency (enqueue ->
  worker pickup, the signal ``InvocationMonitor`` already records) exceeds
  ``target_queue_p95_s`` — bounded by ``max_workers`` and a per-decision
  cooldown so one congested wait-loop iteration cannot stampede to max.
* **Reap** warm containers idle past ``idle_ttl_s`` (no in-flight action,
  nothing dispatched to them recently), down to ``min_workers`` — the
  Lithops "expire idle runtime" behavior. Reaping deliberately discards
  the container's FleetRuntime warmth; sticky routes pointing at a reaped
  worker fall back to the least-busy live worker and re-pin on success.

Every decision lands in ``events`` (and ``summary()``), so the
worker-count trajectory under load is a record, not a log line.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class AutoscalePolicy:
    min_workers: int = 1
    max_workers: int = 8
    target_queue_p95_s: float = 0.5   # scale out above this queue latency
    idle_ttl_s: float = 30.0          # reap containers idle this long
    scale_step: int = 1               # workers added per decision
    cooldown_s: float = 0.0           # min seconds between scale-outs
    window: int = 64                  # recent invocations for the p95

    def __post_init__(self):
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")


class Autoscaler:
    """Owns the scale decisions for one backend. Driven by the invoker:
    ``note_dispatch``/``note_done`` maintain per-worker last-use,
    ``observe`` runs in the wait loop, ``reap_idle`` additionally at
    phase end (and on demand, e.g. after a quiet period)."""

    def __init__(self, backend, policy: AutoscalePolicy, monitor):
        self.backend = backend
        self.policy = policy
        self.monitor = monitor
        self.events: List[dict] = []
        self.scale_outs = 0
        self.reaps = 0
        self._lock = threading.Lock()
        self._last_scale = -1e18
        self._t0 = time.perf_counter()
        self._last_used: Dict[str, float] = {
            w: self._t0 for w in backend.worker_ids()}
        # converge the starting pool into the policy band
        while len(self.backend.worker_ids()) < policy.min_workers:
            self._add("init")

    # ------------------------------------------------------------ notes
    def note_dispatch(self, worker_id: str,
                      now: Optional[float] = None) -> None:
        self._last_used[worker_id] = (time.perf_counter()
                                      if now is None else now)

    note_done = note_dispatch

    # ------------------------------------------------------- decisions
    def observe(self, *, backlog: int, busy: Dict[str, int],
                now: Optional[float] = None) -> None:
        """One wait-loop heartbeat: ``backlog`` not-yet-dispatched
        invocations, ``busy`` in-flight count per worker."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            live = self.backend.worker_ids()
            if (backlog > 0 and len(live) < self.policy.max_workers
                    and now - self._last_scale >= self.policy.cooldown_s):
                all_busy = all(busy.get(w, 0) > 0 for w in live)
                p95 = self.monitor.recent_queue_p95(self.policy.window)
                if all_busy or p95 > self.policy.target_queue_p95_s:
                    room = self.policy.max_workers - len(live)
                    for _ in range(min(self.policy.scale_step, room)):
                        self._add("backlog" if all_busy else "queue_p95",
                                  now=now, backlog=backlog, p95=p95)
                    self._last_scale = now
        self.reap_idle(busy=busy, now=now)

    def reap_idle(self, *, busy: Optional[Dict[str, int]] = None,
                  now: Optional[float] = None) -> List[str]:
        """Remove containers idle past the TTL (never below min_workers,
        never one with an in-flight action)."""
        now = time.perf_counter() if now is None else now
        reaped: List[str] = []
        with self._lock:
            for w in list(self.backend.worker_ids()):
                live = self.backend.worker_ids()
                if len(live) <= self.policy.min_workers:
                    break
                if busy is not None and busy.get(w, 0) > 0:
                    continue
                idle_s = now - self._last_used.get(w, self._t0)
                if idle_s <= self.policy.idle_ttl_s:
                    continue
                if self.backend.remove_worker(w):
                    self._last_used.pop(w, None)
                    self.reaps += 1
                    reaped.append(w)
                    self.events.append({
                        "t": now - self._t0, "action": "reap",
                        "worker": w, "idle_s": idle_s,
                        "workers": len(self.backend.worker_ids())})
        return reaped

    def _add(self, reason: str, *, now: Optional[float] = None,
             **info) -> str:
        now = time.perf_counter() if now is None else now
        w = self.backend.add_worker()
        self._last_used[w] = now
        self.scale_outs += 1
        self.events.append({"t": now - self._t0, "action": "scale_out",
                            "worker": w, "reason": reason,
                            "workers": len(self.backend.worker_ids()),
                            **info})
        return w

    # ------------------------------------------------------------ stats
    def summary(self) -> dict:
        with self._lock:
            workers = self.backend.worker_ids()
            return {"workers": len(workers),
                    "min_workers": self.policy.min_workers,
                    "max_workers": self.policy.max_workers,
                    "scale_outs": self.scale_outs,
                    "reaps": self.reaps,
                    "peak_workers": max(
                        [e["workers"] for e in self.events
                         if e["action"] == "scale_out"] + [len(workers)]),
                    "events": list(self.events)}
