"""The minutely anomaly-detection flow (paper §2 derived signals +
ROADMAP item 2).

``DetectionDeployment`` is a flow-typed ``ModelDeployment``: it binds the
band-compare detector to a monitored context and schedules ``detect``
occurrences (typically every minute) instead of train/score. The
scheduler treats ``detect`` as a third task phase, the fleet executor
runs whole detection bins as ONE vectorized band-compare, and the
serverless invoker ships detection bins with the same exactly-once
payload protocol as forecasting.

``DetectionStore`` is the flow's idempotent persistence: one
``DetectionRecord`` per (deployment, occurrence boundary), however many
times at-least-once delivery executes it. On FIRST save of a record the
store also appends ``(scheduled_at, score)`` to the context's *derived
anomaly signal* — registered through the ``SemanticGraph`` so downstream
consumers query it like any other series (``Castor.read("X.anomaly",
entity)``). Idempotence is what keeps the derived series append-only
correct under chaos: a duplicate execution is dropped before it can
double-append.
"""
from __future__ import annotations

import threading
from collections import deque
from contextlib import nullcontext
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from ..core.deployment import DeploymentStore, ModelDeployment
from ..core.scheduler import Schedule
from ..core.semantics import Signal
from ..obs.metrics import get_metrics


@dataclass
class DetectionDeployment(ModelDeployment):
    """A detection-flow deployment: ``detect`` fires at minutely cadence;
    ``train``/``score`` stay None (the banded forecast it compares
    against is produced by a separate forecast-flow deployment on the
    same context)."""
    flow: str = "detection"


@dataclass(frozen=True)
class DetectionRecord:
    """One detection occurrence's outcome — the detection analogue of a
    ``Forecast``. ``score`` is the worst normalized band exceedance over
    the occurrence's reading window (0.0 = all in band)."""
    deployment_name: str
    signal: str                   # monitored signal
    entity: str
    scheduled_at: float           # occurrence boundary (lineage timestamp)
    score: float
    n_readings: int               # readings scored in the window
    n_anomalies: int              # readings that exceeded the band
    band_misses: int              # readings outside the band's horizon
    model_version: int            # version of the forecast compared against
    derived_signal: str           # e.g. "ENERGY_LOAD.anomaly"


class DetectionStore:
    """Idempotent on (deployment, scheduled_at) — the detection analogue
    of ``PredictionStore`` — plus the derived-signal write-back."""

    def __init__(self, store=None, graph=None, *, rolling_window: int = 64):
        self._store = store
        self._graph = graph
        self._by_dep: Dict[str, List[DetectionRecord]] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        # per-deployment rolling forecast-error gauges (ROADMAP item-4
        # prerequisite): the mean band-exceedance score over the last
        # ``rolling_window`` occurrences, surfaced in the metrics
        # registry as ``detection.rolling_error.<deployment>`` — the
        # drift signal a retraining trigger would threshold on.
        # dep -> [deque, running_sum, gauge]; running sum so a minutely
        # fleet pays O(1) per record, not O(window)
        self.rolling_window = int(rolling_window)
        self._roll: Dict[str, list] = {}
        # (derived_signal, entity) -> ts_id: derived contexts are static
        # once registered, so a minutely fleet resolves each ONCE instead
        # of one graph round-trip per record per bin
        self._ts_ids: Dict[tuple, str] = {}
        # flow telemetry (Castor.stats)
        self.scored_readings = 0
        self.anomalies_flagged = 0
        self.band_misses = 0
        self.journal = None           # durability.Journal when Castor.open'd

    def save(self, rec: DetectionRecord) -> DetectionRecord:
        self.save_many([rec])
        return rec

    def save_many(self, recs: List[DetectionRecord],
                  write_back: bool = True) -> None:
        """One lock acquisition AND one batched derived-signal append per
        fleet bin (mirrors ``PredictionStore.save_many``; per-record
        ``store.append`` round-trips dominated the minutely bin before
        batching).

        Durability: the bin's fresh records journal as ONE atomic "det"
        record that SUBSUMES the derived-signal write-back — the inner
        ``append_points`` is journal-suppressed, because a torn WAL tail
        splitting a detection from its derived points (in either order)
        would diverge from any state a live run passes through. WAL
        replay re-runs ``save_many(write_back=True)``; snapshot replay
        passes ``write_back=False`` (the snapshotted series already hold
        every derived point)."""
        seen = self._seen
        by_dep_setdefault = self._by_dep.setdefault
        ts_ids_get = self._ts_ids.get
        fresh: List[DetectionRecord] = []
        write_back = write_back and self._store is not None \
            and self._graph is not None
        readings = anomalies = misses = 0
        j = self.journal
        with self._lock:
            ids: List[str] = []
            ts: List[float] = []
            vs: List[float] = []
            n_seen = len(seen)
            for rec in recs:
                key = (rec.deployment_name, float(rec.scheduled_at))
                # add-then-compare-length: one hash probe instead of a
                # membership test followed by an add
                seen.add(key)
                if len(seen) == n_seen:              # duplicate execution
                    continue
                n_seen += 1
                fresh.append(rec)
                by_dep_setdefault(rec.deployment_name, []).append(rec)
                readings += rec.n_readings
                anomalies += rec.n_anomalies
                misses += rec.band_misses
                # rolling forecast-error gauge, O(1) per fresh record
                roll = self._roll.get(rec.deployment_name)
                if roll is None:
                    roll = self._roll[rec.deployment_name] = [
                        deque(maxlen=self.rolling_window), 0.0,
                        get_metrics().gauge("detection.rolling_error."
                                            + rec.deployment_name)]
                dq = roll[0]
                if len(dq) == self.rolling_window:
                    roll[1] -= dq[0]
                dq.append(rec.score)
                roll[1] += rec.score
                roll[2].set(roll[1] / len(dq))
                if not write_back:
                    continue
                # derived-signal write-back, exactly once per occurrence:
                # the anomaly score becomes a first-class series on the
                # semantic graph, queryable like any ingested signal
                ckey = (rec.derived_signal, rec.entity)
                tid = ts_ids_get(ckey)
                if tid is None:
                    if rec.derived_signal not in self._graph.signals:
                        self._graph.add_signal(Signal(
                            rec.derived_signal, unit="score",
                            description=f"band-exceedance anomaly score "
                                        f"of {rec.signal}"))
                    tid = self._graph.context(rec.derived_signal,
                                              rec.entity).ts_id
                    self._ts_ids[ckey] = tid
                ids.append(tid)
                ts.append(rec.scheduled_at)
                vs.append(rec.score)
            self.scored_readings += readings
            self.anomalies_flagged += anomalies
            self.band_misses += misses
            if ids:
                with j.suppressed() if j is not None else nullcontext():
                    self._store.append_points(ids, ts, vs)
            if j is not None and fresh:
                j.append("det", {"records": [asdict(r) for r in fresh],
                                 "wb": write_back})

    def rolling_errors(self) -> Dict[str, float]:
        """{deployment: mean score over its last ``rolling_window``
        occurrences} — the per-deployment drift signal (also exported as
        ``detection.rolling_error.*`` gauges in the metrics registry)."""
        with self._lock:
            return {dep: roll[1] / len(roll[0])
                    for dep, roll in self._roll.items() if roll[0]}

    def history(self, deployment_name: str) -> List[DetectionRecord]:
        return list(self._by_dep.get(deployment_name, ()))

    def deployment_names(self) -> List[str]:
        return sorted(self._by_dep)

    def count(self) -> int:
        return sum(len(v) for v in self._by_dep.values())

    def stats(self) -> dict:
        # scored_readings counts every reading a detection inspected;
        # band_misses is the subset whose timestamps fell outside the
        # resolved band's horizon (stale band), so the rate is miss/total
        return {"records": self.count(),
                "scored_readings": self.scored_readings,
                "anomalies_flagged": self.anomalies_flagged,
                "band_misses": self.band_misses,
                "band_miss_rate":
                    (self.band_misses / self.scored_readings
                     if self.scored_readings else 0.0)}


def deploy_detections_for_all(
        graph, deployments: DeploymentStore, *, package: str, signal: str,
        name_prefix: str, detect: Schedule,
        user_params: Optional[dict] = None, version: Optional[str] = None,
        kind: Optional[str] = None, under: Optional[str] = None,
        rank: int = 0) -> List[DetectionDeployment]:
    """``deploy_for_all`` for the detection flow: one
    ``DetectionDeployment`` per entity carrying ``signal`` — typically
    applied over an existing forecast fleet so every monitored context
    gets a minutely detector against its own banded forecasts.

    Same incremental-idempotent contract as ``deploy_for_all``:
    re-applying the identical rule deploys only new contexts; a same-name
    deployment with a different rule collides loudly."""
    out = []
    for ent in graph.find_entities(kind=kind, has_signal=signal, under=under):
        name = f"{name_prefix}-{ent.name}"
        if name in deployments:        # already applied to this context
            prev = deployments.get(name)
            if (prev.package, prev.version, prev.signal, prev.entity,
                    getattr(prev, "detect", None), prev.rank,
                    prev.user_params, getattr(prev, "flow", None)) \
                    != (package, version, signal, ent.name, detect, rank,
                        dict(user_params or {}), "detection"):
                raise ValueError(
                    f"deployment {name} already registered with a "
                    f"different configuration; re-apply the identical "
                    "rule, or use a different name_prefix")
            continue
        dep = DetectionDeployment(
            name=name, package=package, version=version, signal=signal,
            entity=ent.name, detect=detect,
            user_params=dict(user_params or {}), rank=rank)
        out.append(deployments.register(dep))
    return out
