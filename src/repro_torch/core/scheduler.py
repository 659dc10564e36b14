"""Model scheduling (paper §2 step (7)): periodically load registered
deployments, decide which are due for training/scoring, and emit jobs.

Jobs carry a *bin key* so the fleet executor can megabatch identical
(implementation, task) work — the accelerator-native analogue of
launching thousands of serverless containers.

Scale architecture (million-deployment control plane): the scheduler is
a **calendar queue** — a heap of wake-up entries ``(due_time, generation,
name, task)`` — not a fleet scanner. ``poll(now)`` pops only entries with
``due <= now``, so a steady-state poll costs O(due · log fleet), flat in
fleet size. Invariants:

* each live ``(deployment, task)`` owns one *boundary* entry armed at its
  next not-yet-emitted occurrence; it is re-armed on every emit;
* ``mark_failed`` pushes a transient *retry* entry at the failed stamp
  (<= now, so the very next poll wakes the deployment up);
* entries are invalidated lazily through a per-name generation counter:
  ``DeploymentStore.remove`` bumps it (via the store's listener protocol,
  which also eagerly clears watermarks and queued retries), so a
  re-registered same-name deployment starts from scratch instead of
  inheriting stale wake-ups — and a schedule edit (remove + re-register
  with a new ``Schedule``) re-keys the calendar entry;
* duplicate entries are benign: poll de-duplicates per (name, task) at
  pop time, and all of one key's stale duplicates collapse when they pop.

Bin keys are additionally interned to dense ints (``Job.bin_id``) so
``bin_jobs`` groups with one numpy argsort over an integer axis instead
of hashing tuples of strings per job.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .interning import InternTable


@dataclass(frozen=True)
class Schedule:
    """Start time + repeat interval, both in epoch seconds."""
    start: float
    every: float

    def index_at(self, t: float) -> int:
        """Largest occurrence index ``k >= -1`` with
        ``start + k*every <= t``.

        The f64 quotient ``(t - start) / every`` can floor one step high
        or low for large ``t`` / small ``every`` (its rounding error
        exceeds the gap to the next integer), which skipped or
        double-fired boundaries — the same drift class ``Castor.run_until``
        guards against. The estimate is therefore corrected against
        the boundary lattice *itself*: the returned index is exact for
        the float values ``start + k*every``, the very expression
        ``boundaries_due`` stamps jobs with, so count, stamps, and the
        next-due wake-up can never disagree."""
        if t < self.start:
            return -1
        k = int((t - self.start) // self.every)
        # each loop runs O(1) times: the estimate is within a few ULPs
        while self.start + (k + 1) * self.every <= t:
            k += 1
        while k > 0 and self.start + k * self.every > t:
            k -= 1
        return k

    def occurrences_due(self, last_run: Optional[float], now: float) -> int:
        """How many firings are due in (last_run, now]."""
        k_now = self.index_at(now)
        if k_now < 0:
            return 0
        if last_run is None:
            return 1                                    # fire once, catch up
        if last_run < self.start:
            return k_now + 1
        return max(0, k_now - self.index_at(last_run))

    def boundaries_due(self, last_run: Optional[float], now: float,
                       limit: Optional[int] = None) -> List[float]:
        """The due occurrences' scheduled boundary timestamps
        (start + k*every), oldest first; with ``limit``, the most recent
        ones. Count and stamps come from the SAME lattice-corrected
        arithmetic (``index_at``), so they cannot disagree."""
        due = self.occurrences_due(last_run, now)
        if due <= 0:
            return []
        if limit:
            due = min(due, limit)
        k_now = self.index_at(now)
        return [self.start + k * self.every
                for k in range(k_now - due + 1, k_now + 1)]

    def next_boundary_after(self, t: float) -> float:
        """The first boundary strictly after ``t`` (``start`` when
        ``t < start``) — what the calendar queue arms wake-ups at."""
        return self.start + (self.index_at(t) + 1) * self.every


# ------------------------------------------------------------------ jobs

#: every schedulable task name, in dependency order: trains feed scores
#: (a scoring job may consume the version trained this cycle) and scores
#: feed detects (a detection compares against the band scored this cycle)
TASKS = ("train", "score", "detect")
_TASK_ORDER = {t: i for i, t in enumerate(TASKS)}

#: process-wide intern table for bin keys; ids are what the executors,
#: the serverless invoker and the vectorized grouping below operate on
BIN_KEYS = InternTable()


def intern_bin_key(key: Tuple) -> int:
    return BIN_KEYS.intern(key)


def bin_key_of(bin_id: int) -> Tuple:
    """The human-readable bin-key tuple behind an interned id."""
    return BIN_KEYS.value(bin_id)


@dataclass(frozen=True)
class Job:
    deployment_name: str
    package: str
    version: str                    # RESOLVED version (registry pinned at poll)
    task: str                       # "train" | "score" | "detect"
    scheduled_at: float
    signal: str
    entity: str
    user_params_key: str = ""       # part of the bin key (same config batches)

    @property
    def bin_key(self) -> Tuple[str, str, str, str, float]:
        # scheduled_at is part of the key: a fleet score bin shares ONE
        # execution time axis (ForecastModelBase._require_one_window), so
        # catch-up occurrences stamped at different boundaries must land in
        # different bins instead of poisoning one megabatch
        return (self.package, self.version, self.task, self.user_params_key,
                self.scheduled_at)

    @property
    def bin_id(self) -> int:
        """Interned dense-int twin of ``bin_key`` (memoized per job):
        equal bin keys <=> equal ints, for this process's lifetime."""
        bid = self.__dict__.get("_bin_id")
        if bid is None:
            bid = BIN_KEYS.intern(self.bin_key)
            object.__setattr__(self, "_bin_id", bid)
        return bid


class ModelScheduler:
    """Calendar-queue scheduler: tracks last-run state per
    (deployment, task) and emits due jobs by popping the wake-up heap
    (see the module docstring for the queue invariants).

    ``max_catchup`` bounds how many occurrences ONE poll may emit per
    (deployment, task) — queued failure retries and newly missed
    boundaries combined: a live poller that stalled for weeks, or a
    permanently failing deployment whose every occurrence re-queues, must
    not turn polling into an unbounded replay storm (each occurrence is a
    full megabatch bin). The most recent boundaries win; older ones are
    dropped. Set it falsy for unlimited replay."""

    def __init__(self, deployments, registry, *,
                 max_catchup: Optional[int] = 168):
        self.deployments = deployments
        self.registry = registry
        self.max_catchup = max_catchup
        self._last: Dict[Tuple[str, str], float] = {}
        self._failed: Dict[Tuple[str, str], set] = {}   # scheduled_at stamps
        self._heap: List[Tuple[float, int, str, str]] = []
        self._gen: Dict[str, int] = {}      # name -> live entry generation
        # (name, task) keys whose watermark/retry state changed since the
        # last drain — what the durability journal persists per tick as
        # ONE atomic "sched" record (see drain_dirty)
        self._dirty: set = set()
        # params-key memo per user_params dict identity: repr-ing every
        # deployment's params dict on every poll was measurable on the
        # steady-state hot path. The memo holds a snapshot COPY and
        # re-validates with a (cheap) dict equality, so both a swapped
        # dict (new id) and an in-place mutation recompute the key.
        self._pk: Dict[int, Tuple[dict, str]] = {}
        # the store pushes register/remove events at us so the queue stays
        # incremental; a pre-populated store seeds the queue here
        subscribe = getattr(deployments, "subscribe", None)
        if subscribe is not None:
            subscribe(self)
        for dep in deployments.all():
            self.on_register(dep)

    # ------------------- deployment-store listener protocol -------------
    def on_register(self, dep) -> None:
        """Arm a wake-up at each schedule's start: ``occurrences_due(None,
        now)`` fires exactly when ``now >= start``, which is exactly when
        the entry pops."""
        for task in TASKS:
            sched: Optional[Schedule] = getattr(dep, task, None)
            if sched is not None:
                self._push(sched.start, dep.name, task)

    def on_remove(self, name: str) -> None:
        """Clear ALL scheduler state keyed by the removed deployment:
        watermarks, queued failure stamps, and (lazily, via the generation
        bump) heap entries. Without this, re-registering a same-name
        deployment inherited the old watermark — so it never caught up
        from scratch — and replayed the removed deployment's queued
        retries against the new one's schedules."""
        self._gen[name] = self._gen.get(name, 0) + 1
        for task in TASKS:
            self._last.pop((name, task), None)
            self._failed.pop((name, task), None)
            self._dirty.discard((name, task))   # "rmdep" subsumes the delta

    def _push(self, due: float, name: str, task: str) -> None:
        heapq.heappush(self._heap,
                       (due, self._gen.get(name, 0), name, task))

    def _params_key(self, params: dict) -> str:
        hit = self._pk.get(id(params))
        if hit is not None and hit[0] == params:
            return hit[1]
        if len(self._pk) > 4096:
            self._pk.clear()
        k = _params_key(params)
        self._pk[id(params)] = (dict(params), k)
        return k

    def poll(self, now: float) -> List[Job]:
        """The poll is ATOMIC: watermarks advance, queued retries clear
        and wake-ups re-arm only after every due deployment's registry
        lookup has succeeded — a raising lookup (e.g. a deployment of a
        never-published package) pushes every popped entry back and
        leaves ALL per-deployment state untouched, so no occurrence can
        be emitted into a poll that then throws the jobs away."""
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        if not tracer.enabled:
            return self._poll(now)
        with tracer.span("scheduler.poll", now=now) as sp:
            jobs = self._poll(now)
            sp.set(jobs=len(jobs))
            return jobs

    def _poll(self, now: float) -> List[Job]:
        heap = self._heap
        popped: List[Tuple[float, int, str, str]] = []  # for atomic restore
        keys: Dict[Tuple[str, str], bool] = {}          # de-dup, pop order
        while heap and heap[0][0] <= now:
            entry = heapq.heappop(heap)
            _due, gen, name, task = entry
            if gen != self._gen.get(name, 0) \
                    or name not in self.deployments:
                continue                    # stale entry: drop forever
            popped.append(entry)
            keys[(name, task)] = True
        jobs: List[Job] = []
        planned: List[tuple] = []   # (dep, task, key, sched, stamps, adv, ver)
        try:
            for name, task in keys:
                dep = self.deployments.get(name)
                sched: Optional[Schedule] = getattr(dep, task, None)
                key = (name, task)
                if sched is None:           # schedule dropped since arming
                    continue
                # one job PER missed occurrence, stamped at its scheduled
                # boundary — forecasts and model versions must carry
                # lineage timestamps of when the work was DUE, not
                # whenever the poll happened to run (Castor persists
                # rolling-horizon predictions at their scheduled times) —
                # plus failed occurrences re-firing at their ORIGINAL
                # boundaries
                new = sched.boundaries_due(self._last.get(key), now,
                                           self.max_catchup)
                stamps = sorted(self._failed.get(key, ())) + new
                if self.max_catchup:
                    # retries + new boundaries share the cap (stamps are
                    # chronological: queued retries predate new ones)
                    stamps = stamps[-self.max_catchup:]
                if not stamps:
                    # spurious wake-up (duplicate retry entry whose stamps
                    # were already emitted): just re-arm the boundary
                    planned.append((dep, task, key, sched, [], False, None))
                    continue
                version = self.registry.resolve_version(dep.package,
                                                        dep.version)
                planned.append((dep, task, key, sched, stamps, bool(new),
                                version))
        except Exception:
            for entry in popped:            # atomic: restore the queue
                heapq.heappush(heap, entry)
            raise
        # every lookup succeeded: commit state, re-arm wake-ups, and emit
        for dep, task, key, sched, stamps, advance, version in planned:
            if self._failed.pop(key, None) is not None or advance:
                self._dirty.add(key)
            if advance:
                self._last[key] = now
            self._push(sched.next_boundary_after(now), dep.name, task)
            for ts in dict.fromkeys(stamps):
                jobs.append(Job(
                    deployment_name=dep.name, package=dep.package,
                    version=version, task=task, scheduled_at=ts,
                    signal=dep.signal, entity=dep.entity,
                    user_params_key=self._params_key(dep.user_params)))
        # deterministic order: train before score before detect, then
        # chronological (catch-up occurrences execute oldest first), then
        # by name
        jobs.sort(key=lambda j: (_TASK_ORDER.get(j.task, 1), j.scheduled_at,
                                 j.deployment_name))
        return jobs

    def mark_failed(self, job: Job):
        """The failed job re-fires on the next poll at its ORIGINAL
        occurrence boundary (at-least-once per occurrence). Queuing the
        stamp — rather than resetting the deployment's whole watermark —
        means one failed catch-up occurrence cannot be collapsed away by
        its siblings' success and then silently deduplicated against the
        idempotent version/prediction stores. The retry entry's due time
        is the stamp itself (already past), so the next poll pops it.

        A failure surfacing AFTER its deployment was removed (the job was
        in flight when ``remove`` ran) is dropped: recording it would
        queue a stale retry against a future same-name re-registration,
        exactly the state ``on_remove`` exists to clear."""
        if job.deployment_name not in self.deployments:
            return
        key = (job.deployment_name, job.task)
        self._failed.setdefault(key, set()).add(job.scheduled_at)
        self._dirty.add(key)
        self._push(job.scheduled_at, job.deployment_name, job.task)

    # ---------------------- durability surface --------------------------
    def _state_entry(self, key: Tuple[str, str]) -> list:
        name, task = key
        wm = self._last.get(key)
        return [name, task, wm, sorted(self._failed.get(key, ()))]

    def drain_dirty(self) -> Optional[dict]:
        """The watermark/retry delta since the last drain, as one
        journal-record payload — or None when nothing changed. Appended
        by ``Castor.tick`` AFTER the tick's effect records, so a torn WAL
        tail can only leave "effects persisted, watermark behind": the
        whole boundary then re-fires on recovery and the idempotent
        stores absorb the duplicated prefix. An entry's stamp list
        replaces the key's retry set wholesale (empty = cleared)."""
        if not self._dirty:
            return None
        entries = [self._state_entry(k) for k in sorted(self._dirty)]
        self._dirty.clear()
        return {"keys": entries}

    def dump_state(self) -> dict:
        """Full watermark/retry state (snapshot records)."""
        keys = sorted(set(self._last) | set(self._failed))
        return {"keys": [self._state_entry(k) for k in keys]}

    def restore_state(self, d: dict) -> None:
        """Apply a "sched" record: per-key wholesale replacement. Retry
        stamps are re-armed on the heap so the next poll re-fires them,
        exactly as ``mark_failed`` would have."""
        for name, task, wm, stamps in d.get("keys", ()):
            key = (name, task)
            if wm is None:
                self._last.pop(key, None)
            else:
                self._last[key] = float(wm)
            if stamps:
                self._failed[key] = {float(s) for s in stamps}
                for s in stamps:
                    self._push(float(s), name, task)
            else:
                self._failed.pop(key, None)

    def stats(self) -> dict:
        return {"heap_entries": len(self._heap),
                "tracked": len(self._last),
                "failed_keys": len(self._failed),
                "interned_bins": len(BIN_KEYS)}


def _params_key(params: dict) -> str:
    return repr(sorted(params.items()))


#: below this many jobs, plain dict grouping beats numpy's fixed overhead
_VECTORIZE_MIN = 96


def bin_jobs(jobs: List[Job]) -> Dict[Tuple, List[Job]]:
    """Group jobs into executor bins.

    Grouping runs over the INTERNED integer bin ids — one numpy
    argsort/unique over an int64 axis — instead of hashing each job's
    tuple-of-strings key. The returned dict is still keyed by the
    human-readable ``bin_key`` tuples, in first-appearance order (callers
    iterate it to execute bins in the phase's chronological order), so
    the grouping is bitwise-indistinguishable from the dict-based one."""
    n = len(jobs)
    if n < _VECTORIZE_MIN:
        bins: Dict[Tuple, List[Job]] = {}
        for j in jobs:
            bins.setdefault(j.bin_key, []).append(j)
        return bins
    # single-bin fast path on raw attributes: a uniform fleet phase (the
    # steady-state minutely detect poll above all) is ONE bin, and per-job
    # bin-key interning is measurable at fleet width
    j0 = jobs[0]
    p0, v0, t0 = j0.package, j0.version, j0.task
    u0, s0 = j0.user_params_key, j0.scheduled_at
    if all(j.scheduled_at == s0 and j.package == p0 and j.version == v0
           and j.task == t0 and j.user_params_key == u0 for j in jobs):
        return {j0.bin_key: list(jobs)}
    ids = np.fromiter((j.bin_id for j in jobs), dtype=np.int64, count=n)
    uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(inv, kind="stable")      # groups contiguous, members
    starts = np.zeros(len(uniq) + 1, dtype=np.int64)    # in original order
    np.cumsum(np.bincount(inv, minlength=len(uniq)), out=starts[1:])
    out: Dict[Tuple, List[Job]] = {}
    for g in np.argsort(first, kind="stable"):  # first-appearance order
        members = order[starts[g]:starts[g + 1]]
        out[bin_key_of(int(uniq[g]))] = [jobs[i] for i in members]
    return out
