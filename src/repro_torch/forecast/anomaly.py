"""Band-compare anomaly scorer — the minutely detection flow's model.

A ``DetectionDeployment`` (flows.detection) schedules ``detect``
occurrences at minutely cadence. Each occurrence reads the live values
of the monitored context over a short lookback window and compares them
against the q10/q90 prediction band of the forecast a live poller would
have had at that boundary (the band is resolved by the executor with
``predictions.latest(signal, entity, at=scheduled_at)`` — the same
replay-faithful ``at=`` semantics model versions use).

The occurrence's anomaly score is the worst normalized band exceedance
over the window::

    exceed(v) = max(lower(t) - v, v - upper(t), 0) / max(upper - lower, eps)

0.0 means every reading sat inside the band; 1.0 means a reading escaped
the band by one full band-width. Readings whose timestamps fall outside
the band's horizon count as *band misses* (telemetry, not anomalies).

Fleet execution is the point: ``fleet_detect`` scores a whole bin with
ONE ``store.read_many`` and one vectorized compare over the flattened
(sensor, reading) axis — no per-sensor Python loop. The per-sensor
``detect`` path computes bitwise-identical scores (same float64
elementwise operations), which ``benchmarks/bench_detection.py`` and
``tests/test_flows.py`` pin.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.registry import ModelInterface
from ..flows.detection import DetectionRecord
from ..obs.metrics import note_retrace

#: floor on band width when normalizing exceedance (degenerate bands)
EPS = 1e-9


def _band_grid(fc) -> tuple:
    """(t0, step, H) of a banded forecast's horizon grid."""
    t0 = float(fc.times[0])
    step = float(fc.times[1] - fc.times[0]) if len(fc.times) > 1 else 1.0
    return t0, step, len(fc.times)


#: band-pack memo: stacked (t0s, steps, Hs, L, U) per bin's band list.
#: Forecasts are frozen and a minutely bin re-resolves the SAME bands
#: until the next scoring boundary, so the stacks are rebuilt only when
#: the band set actually changes. Keyed by the forecasts' ids; the value
#: holds the bands tuple itself, which pins those ids live. Tiny cap —
#: one entry per concurrently-detecting bin is all steady state needs.
_BAND_PACKS: dict = {}
_BAND_PACKS_MAX = 8


def _band_pack(bands):
    """(t0s, steps, Hs, L, U, mvs) stacks for a bin's bands; L/U are None
    for ragged horizons (the caller gathers per sensor instead)."""
    key = tuple(map(id, bands))
    hit = _BAND_PACKS.get(key)
    if hit is not None:
        return hit[1]
    # the detection path's retrace analogue: a rebuild means the bin's
    # band set changed (new scoring boundary), counted like a jit retrace
    note_retrace("band_pack")
    grids = [_band_grid(fc) for fc in bands]
    t0s = np.asarray([g[0] for g in grids])
    steps = np.asarray([g[1] for g in grids])
    Hs = np.asarray([g[2] for g in grids], np.int64)
    if len(set(Hs.tolist())) == 1:
        L = np.stack([np.asarray(fc.lower, np.float64) for fc in bands])
        U = np.stack([np.asarray(fc.upper, np.float64) for fc in bands])
    else:
        L = U = None
    pack = (t0s, steps, Hs, L, U, [fc.model_version for fc in bands])
    if len(_BAND_PACKS) >= _BAND_PACKS_MAX:
        _BAND_PACKS.pop(next(iter(_BAND_PACKS)))
    _BAND_PACKS[key] = (tuple(bands), pack)
    return pack


def _exceedances(rv, lo, hi):
    """Normalized band exceedance per reading (float64, elementwise —
    the single-sensor and fleet paths share these exact operations)."""
    width = np.maximum(hi - lo, EPS)
    return np.maximum(np.maximum(lo - rv, rv - hi), 0.0) / width


class BandAnomalyDetector(ModelInterface):
    """Model-free detection: the "model" is the banded forecast itself."""

    KIND = "ANOM"
    SUPPORTS_FLEET = True
    SUPPORTS_RUNTIME = False
    DEFAULTS = {"lookback": 60.0}

    # ------------- 4-function interface (detect flow) -------------
    def load(self):
        up = {**self.DEFAULTS, **self.user_params}
        now = float(up.get("now", 0.0))
        # half-open [now - lookback, now): exactly the readings that
        # arrived since the previous minutely occurrence
        self._raw = self.system.store.read(
            self.context.ts_id, now - float(up["lookback"]), now)
        self._now = now
        return self._raw

    def transform(self):
        return self._raw

    def train(self):
        # nothing to fit — banded forecasts come from the forecast flow
        return {"kind": self.KIND}

    def score(self, model_object):
        raise RuntimeError(
            "detection deployments schedule 'detect', not 'score'")

    # ------------- detection -------------
    def _derived_signal(self) -> str:
        up = {**self.DEFAULTS, **self.user_params}
        return str(up.get("derived_signal",
                          f"{self.context.signal.name}.anomaly"))

    def detect(self, fc) -> DetectionRecord:
        """Per-sensor reference path (LocalPoolExecutor): one ``read()``
        and one compare for this sensor's window."""
        self.load()
        rt, rv = (np.asarray(self._raw[0], np.float64),
                  np.asarray(self._raw[1], np.float64))
        t0, step, H = _band_grid(fc)
        idx = np.floor((rt - t0) / step + 0.5).astype(np.int64)
        ok = (idx >= 0) & (idx < H)
        ex = _exceedances(rv[ok], np.asarray(fc.lower, np.float64)[idx[ok]],
                          np.asarray(fc.upper, np.float64)[idx[ok]])
        score = float(ex.max()) if ex.size else 0.0
        return DetectionRecord(
            deployment_name=self.model_id,
            signal=self.context.signal.name,
            entity=self.context.entity.name,
            scheduled_at=self._now, score=score,
            n_readings=int(rt.size),
            n_anomalies=int(np.count_nonzero(ex > 0.0)),
            band_misses=int(np.count_nonzero(~ok)),
            model_version=fc.model_version,
            derived_signal=self._derived_signal())

    @classmethod
    def fleet_detect(cls, instances: List["BandAnomalyDetector"],
                     bands, now=None, ts_ids=None,
                     names=None) -> List[DetectionRecord]:
        """Whole-bin detection: ONE ``store.read_many`` for every sensor's
        window, then one vectorized compare over the flattened (sensor,
        reading) axis. Scores are bitwise-identical to the per-sensor
        ``detect`` path (same float64 elementwise ops; the segment max is
        order-independent). ``now`` defaults to the bin's
        ``user_params["now"]``, ``ts_ids`` to the instances' context
        series and ``names`` to per-instance ``(model_ids, signals,
        entities)`` columns (kept as fallbacks so direct callers need no
        executor); the fleet executor passes all three explicitly because
        its cached bin instances outlive any single boundary and the
        name columns hold until the deployment set changes."""
        n = len(instances)
        up = {**cls.DEFAULTS, **instances[0].user_params}
        if now is None:
            now = float(up.get("now", 0.0))
        t0w = now - float(up["lookback"])
        system = instances[0].system
        # since= window read: the steady-state delta fast path (two binary
        # searches per consolidated series), flattened in the store — the
        # vectorized compare wants one concatenated axis anyway
        if ts_ids is None:
            ts_ids = [inst.context.ts_id for inst in instances]
        sizes, rt, rv = system.store.read_many_flat(ts_ids, end=now,
                                                    since=t0w)
        sidx = np.repeat(np.arange(n, dtype=np.int64), sizes)
        t0s, steps, Hs, L, U, mvs = _band_pack(bands)
        idx = np.floor((rt - t0s[sidx]) / steps[sidx] + 0.5).astype(np.int64)
        ok = (idx >= 0) & (idx < Hs[sidx])
        if L is not None:
            lo, hi = L[sidx[ok], idx[ok]], U[sidx[ok], idx[ok]]
        else:                  # ragged horizons: gather per sensor (rare)
            lo = np.asarray([bands[s].lower[i]
                             for s, i in zip(sidx[ok], idx[ok])], np.float64)
            hi = np.asarray([bands[s].upper[i]
                             for s, i in zip(sidx[ok], idx[ok])], np.float64)
        ex = _exceedances(rv[ok], lo, hi)
        scores = np.zeros(n, np.float64)
        np.maximum.at(scores, sidx[ok], ex)
        anom = np.bincount(sidx[ok][ex > 0.0], minlength=n)
        miss = np.bincount(sidx[~ok], minlength=n)
        # one C-loop materialization per column, then pure-python record
        # assembly — per-element float()/int() coercions were measurable
        # at fleet width
        scores_l, sizes_l = scores.tolist(), sizes.tolist()
        anom_l, miss_l = anom.tolist(), miss.tolist()
        if names is None:
            mids = [inst.model_id for inst in instances]
            sigs = [inst.context.signal.name for inst in instances]
            ents = [inst.context.entity.name for inst in instances]
        else:
            mids, sigs, ents = names
        derived = up.get("derived_signal")
        derived_l = [str(derived)] * n if derived is not None \
            else [s + ".anomaly" for s in sigs]
        # frozen-dataclass __init__ routes every field through
        # object.__setattr__; at fleet width that alone was ~7% of a
        # minutely bin, so records are built by installing the field dict
        # directly (__eq__/asdict/attribute reads are unaffected)
        new = DetectionRecord.__new__
        out = []
        for i in range(n):
            rec = new(DetectionRecord)
            rec.__dict__.update({
                "deployment_name": mids[i], "signal": sigs[i],
                "entity": ents[i],
                "scheduled_at": now, "score": scores_l[i],
                "n_readings": sizes_l[i], "n_anomalies": anom_l[i],
                "band_misses": miss_l[i], "model_version": mvs[i],
                "derived_signal": derived_l[i]})
            out.append(rec)
        return out
