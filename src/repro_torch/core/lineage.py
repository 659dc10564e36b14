"""Model-version + prediction lineage (paper §2, Figs. 5-7).

Every trained model version is persisted with metadata; every rolling-horizon
forecast is appended and NEVER overwritten, so historical performance can be
validated across prediction horizons (Fig. 7). The ranking mechanism serves
"the best" prediction per context to downstream consumers that only know the
semantic context.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ModelVersion:
    model_id: str                 # deployment name
    version: int                  # monotonically increasing per model_id
    trained_at: float             # simulation clock
    params: Any                   # fitted parameters (pytree of arrays)
    metadata: Dict = field(default_factory=dict)   # train duration, window, ...


class ModelVersionStore:
    """Idempotent on (model_id, trained_at): duplicate executions of one
    scheduled training job yield one version."""

    def __init__(self):
        self._versions: Dict[str, List[ModelVersion]] = {}
        self._latest: Dict[str, ModelVersion] = {}   # max trained_at memo
        self._lock = threading.Lock()
        self.journal = None           # durability.Journal when Castor.open'd

    def save(self, model_id: str, params, trained_at: float,
             metadata: Optional[dict] = None) -> ModelVersion:
        with self._lock:
            hist = self._versions.setdefault(model_id, [])
            for mv in hist:
                if mv.trained_at == trained_at:      # duplicate execution
                    return mv
            mv = ModelVersion(model_id, len(hist) + 1, trained_at, params,
                              dict(metadata or {}))
            hist.append(mv)
            cur = self._latest.get(model_id)
            if cur is None or (mv.trained_at, mv.version) > \
                    (cur.trained_at, cur.version):
                self._latest[model_id] = mv
            j = self.journal
            if j is not None:         # fresh insert only: replay re-derives
                j.append("mv", {"model_id": model_id,      # the numbering
                                "trained_at": trained_at, "params": params,
                                "metadata": mv.metadata})
            return mv

    def get(self, model_id: str, version: Optional[int] = None, *,
            at: Optional[float] = None) -> Optional[ModelVersion]:
        """Latest means max TRAINED time, not save order: catch-up training
        jobs (one per missed occurrence) may complete out of chronological
        order on a parallel executor, and scoring must never pick a stale
        boundary's model just because it finished last.

        ``at`` replays history faithfully: the newest version with
        ``trained_at <= at`` — a forecast stamped at boundary t must use
        the model a live poller would have had at t, never one trained on
        data observed after t. A replayed occurrence predating the first
        training falls back to the OLDEST version (closest to honest)
        rather than failing forever on at-least-once retries."""
        hist = self._versions.get(model_id)
        if not hist:
            return None
        if version is not None:
            return hist[version - 1]
        latest = self._latest[model_id]
        # steady-state fast path: a live poller's `at` is at/after the
        # newest training, so the memoized latest answers without a scan
        if at is None or latest.trained_at <= at:
            return latest
        key = lambda mv: (mv.trained_at, mv.version)   # noqa: E731
        eligible = [mv for mv in hist if mv.trained_at <= at]
        return max(eligible, key=key) if eligible else min(hist, key=key)

    def history(self, model_id: str) -> List[ModelVersion]:
        return list(self._versions.get(model_id, ()))

    def count(self) -> int:
        return sum(len(v) for v in self._versions.values())

    def model_ids(self) -> List[str]:
        return sorted(self._versions)


@dataclass(frozen=True)
class Forecast:
    deployment_name: str
    signal: str
    entity: str
    created_at: float             # when the scoring job ran
    times: np.ndarray             # horizon timestamps
    values: np.ndarray
    model_version: int
    rank: int = 0
    # q10/q90 prediction band (same shape as values); None for models that
    # predate bands or don't emit residual quantiles. The detection flow
    # compares live readings against these.
    lower: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None


def forecast_record(fc: Forecast) -> Dict[str, Any]:
    """WAL/snapshot payload for one forecast (arrays pass bitwise through
    the codec; ``lower``/``upper`` may be None)."""
    return {"deployment_name": fc.deployment_name, "signal": fc.signal,
            "entity": fc.entity, "created_at": fc.created_at,
            "times": fc.times, "values": fc.values,
            "model_version": fc.model_version, "rank": fc.rank,
            "lower": fc.lower, "upper": fc.upper}


def forecast_from_record(d: Dict[str, Any]) -> Forecast:
    low, up = d.get("lower"), d.get("upper")
    return Forecast(
        deployment_name=d["deployment_name"], signal=d["signal"],
        entity=d["entity"], created_at=float(d["created_at"]),
        times=np.asarray(d["times"]), values=np.asarray(d["values"]),
        model_version=int(d["model_version"]), rank=int(d.get("rank", 0)),
        lower=None if low is None else np.asarray(low),
        upper=None if up is None else np.asarray(up))


def forecast_batch_record(fcs: List["Forecast"]) -> Dict[str, Any]:
    """One WAL/snapshot payload for a whole batch of forecasts.

    A uniform batch (every forecast the same horizon length and dtype,
    all banded or all bandless — the shape every fleet bin produces)
    stacks into four ``(n, h)`` arrays, so the codec encodes 4 large
    blobs instead of ``4n`` small ones; that keeps the per-tick WAL
    append off the warm-poll critical path (``bench_durability`` gate
    (b)). Rows of the stack are bitwise the original arrays. Mixed
    batches fall back to the per-forecast ``{"forecasts": [...]}`` list
    — ``forecasts_from_batch`` replays either format."""
    def _sig(fc):
        band = fc.lower is not None and fc.upper is not None
        if not (isinstance(fc.times, np.ndarray)
                and isinstance(fc.values, np.ndarray)):
            return None
        return (fc.times.shape, fc.times.dtype, fc.values.shape,
                fc.values.dtype, band,
                None if not band else (fc.lower.shape, fc.lower.dtype,
                                       fc.upper.shape, fc.upper.dtype))
    first = _sig(fcs[0]) if fcs else None
    if first is None or any(_sig(fc) != first for fc in fcs):
        return {"forecasts": [forecast_record(fc) for fc in fcs]}
    banded = fcs[0].lower is not None and fcs[0].upper is not None
    times = np.stack([fc.times for fc in fcs])
    if bool((times == times[0]).all()):
        times = times[0]       # one shared horizon grid (the fleet-bin
    return {"meta": [[fc.deployment_name,  # case: same boundary, same
                      fc.signal, fc.entity,  # grid for every sensor)
                      fc.created_at, fc.model_version, fc.rank]
                     for fc in fcs],
            "times": times,
            "values": np.stack([fc.values for fc in fcs]),
            "lower": np.stack([fc.lower for fc in fcs]) if banded else None,
            "upper": np.stack([fc.upper for fc in fcs]) if banded else None}


def forecasts_from_batch(d: Dict[str, Any]) -> List[Forecast]:
    if "forecasts" in d:
        return [forecast_from_record(f) for f in d["forecasts"]]
    times = np.asarray(d["times"])
    values = np.asarray(d["values"])
    shared = times.ndim == values.ndim - 1   # deduped horizon grid
    low, up = d.get("lower"), d.get("upper")
    low = None if low is None else np.asarray(low)
    up = None if up is None else np.asarray(up)
    return [Forecast(deployment_name=dep, signal=sig, entity=ent,
                     created_at=float(created),
                     times=times if shared else times[i],
                     values=values[i], model_version=int(ver),
                     rank=int(rank),
                     lower=None if low is None else low[i],
                     upper=None if up is None else up[i])
            for i, (dep, sig, ent, created, ver, rank)
            in enumerate(d["meta"])]


class PredictionStore:
    """Append-only rolling-horizon forecast store.

    Saves are IDEMPOTENT on (deployment, created_at): retried or speculative
    duplicate executions of the same scheduled scoring job persist once —
    rolling horizons at different created_at are all kept (never overwritten).
    """

    def __init__(self):
        self._by_dep: Dict[str, List[Forecast]] = {}
        self._by_ctx: Dict[Tuple[str, str], List[Forecast]] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        # latest(at=) memo per context: (history_len, chosen, next_created)
        # — a minutely detection fleet resolves its band at every boundary,
        # and the answer only changes when a forecast lands or ``at``
        # crosses the next created_at
        self._latest_memo: Dict[Tuple[str, str], tuple] = {}
        # cache-invalidation surface for executors holding resolved band
        # lists across polls: ``mutations`` bumps on every FRESH save;
        # ``max_created`` bounds the created_at a later ``at`` could newly
        # admit (see FleetExecutor's detect band cache)
        self.mutations = 0
        self.max_created = -float("inf")
        self.journal = None           # durability.Journal when Castor.open'd

    def save(self, fc: Forecast) -> Forecast:
        with self._lock:
            if self._save_locked(fc):
                self._journal_locked([fc])
        return fc

    def save_many(self, fcs: List[Forecast]) -> None:
        """One lock acquisition for a whole fleet bin's forecasts — the
        scoring analogue of ``TimeSeriesStore.read_many`` (N per-forecast
        lock round-trips were measurable at steady state). Journals the
        bin's fresh forecasts as ONE atomic record."""
        with self._lock:
            fresh = [fc for fc in fcs if self._save_locked(fc)]
            self._journal_locked(fresh)

    def _journal_locked(self, fresh: List[Forecast]) -> None:
        j = self.journal
        if j is not None and fresh:
            j.append("fc", forecast_batch_record(fresh))

    def _save_locked(self, fc: Forecast) -> bool:
        key = (fc.deployment_name, float(fc.created_at))
        if key in self._seen:                        # duplicate execution
            return False
        self._seen.add(key)
        self._by_dep.setdefault(fc.deployment_name, []).append(fc)
        self._by_ctx.setdefault((fc.signal, fc.entity), []).append(fc)
        self.mutations += 1
        if fc.created_at > self.max_created:
            self.max_created = float(fc.created_at)
        return True

    def history(self, deployment_name: str) -> List[Forecast]:
        """Full lineage — every rolling-horizon forecast ever produced."""
        return list(self._by_dep.get(deployment_name, ()))

    def deployment_names(self) -> List[str]:
        return sorted(self._by_dep)

    def for_context(self, signal: str, entity: str) -> List[Forecast]:
        return list(self._by_ctx.get((signal, entity), ()))

    def latest(self, signal: str, entity: str,
               at: Optional[float] = None) -> Optional[Forecast]:
        """Best-ranked most-recent forecast for a context (ranking mechanism):
        downstream apps retrieve by semantics only, without knowing which
        model produced the prediction."""
        hist = self._by_ctx.get((signal, entity))
        if not hist:
            return None
        if at is not None:
            # memo fast path: history append-only, so an unchanged length
            # means the same candidate set; the memoized choice stands
            # while ``at`` sits below the next created_at after it
            m = self._latest_memo.get((signal, entity))
            if m is not None:
                n, fc, nxt = m
                if n == len(hist) and fc.created_at <= at \
                        and (nxt is None or at < nxt):
                    return fc
        hist = list(hist)
        cand = [f for f in hist if at is None or f.created_at <= at]
        if not cand:
            return None
        newest = max(f.created_at for f in cand)
        newest_set = [f for f in cand if f.created_at == newest]
        best = min(newest_set, key=lambda f: (f.rank, f.deployment_name))
        if at is not None:
            later = [f.created_at for f in hist if f.created_at > at]
            self._latest_memo[(signal, entity)] = \
                (len(hist), best, min(later) if later else None)
        return best

    def horizons(self, deployment_name: str, target_time: float,
                 tol: float = 1.0) -> List[Tuple[float, float]]:
        """All (created_at, predicted_value) pairs for one target timestamp —
        the Fig. 7 multi-horizon validation view."""
        out = []
        for fc in self.history(deployment_name):
            hit = np.where(np.abs(fc.times - target_time) <= tol)[0]
            if hit.size:
                out.append((fc.created_at, float(fc.values[hit[0]])))
        return sorted(out)

    def count(self) -> int:
        return sum(len(v) for v in self._by_dep.values())
