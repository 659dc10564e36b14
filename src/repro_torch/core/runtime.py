"""FleetRuntime: persistent device-resident per-bin state for the
steady-state poll hot path.

The paper's workload is rolling-horizon operation: thousands of deployed
models re-scored every cycle against a window that slides by a handful of
rows per poll. The cold fleet path re-reads the whole train window from
the store, realigns it and re-uploads everything — O(history) work for
O(1) new data.

``FleetRuntime`` makes the warm poll O(delta) (one object per
``FleetExecutor``; opt out per deployment with ``user_params["runtime"] =
"off"`` or executor-wide with ``FleetExecutor(system, runtime="off")``):

* **Watermark-delta loads.** Per bin, the aligned target history lives in
  a device ring ``(N_bucket, cap)`` next to a boolean *filled* mask. A
  poll reads only ``[watermark, now)`` from the store
  (``read_many(since=..., prior_counts=True)``) and rolls the new rows in
  with one ring update on the device. The ``prior_counts`` handshake
  proves no out-of-order append landed behind the watermark; if one did,
  the bin cold-rebuilds.
* **On-device feature assembly.** Warm train polls assemble the
  lag/weather/calendar design matrix, per-instance standardization
  included, on the device from the ring (``_assemble``); the host numpy
  path stays the cold/reference path.
* **Device-resident versions.** ``fleet_train`` hands its stacked device
  parameters to the bin's state (``note_trained``), so a same-poll score
  bin of those versions neither re-uploads nor re-stacks them; other
  versions are stacked once per set and kept, bucket-padded.
* **Shape buckets.** The ring's instance axis is padded to its
  power-of-two bucket (edge replication).

Window-relative fill semantics are preserved EXACTLY: the cold aligner
forward-fills gaps only from inside ``[t0, now)`` and zero-fills before
the first in-window point, while the ring's fill chain may reach back
before ``t0``. The *filled* mask restores cold semantics at read time
(``y = where(any fill in window so far, ring, 0)``).

A cached bin is invalidated (cold-rebuilt) when: the deployment set /
spec / window length changes (different state key), ``now`` regresses or
is not a whole number of steps past the watermark, a late append lands
behind the watermark, or the delta spans the whole window.

History weather rides in a third ring: history features use OBSERVED
temperatures (deterministic per site/time), so a warm poll computes only
the ``d`` new columns. Horizon weather is a forecast issued at scoring
time (``forecast``, one call per bin).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..forecast.base import stack_versions
from ..forecast.features import (FeatureSpec, align_delta, bucket_n,
                                 design_matrix, edge_pad, fleet_window)
from ..timeseries.transforms import DAY, calendar_features, regular_grid


def _update_rings(ring, filled, ring_t, vals, mask, tvals, T: int,
                  warm_s: int):
    """Roll the target/filled/temperature rings left by ``d`` (the width
    of ``vals``), forward-fill the new target columns from the previous
    ring column (the value the cold aligner would have propagated), and
    return the new rings, the window-masked target matrix and the
    trailing score windows.

    The rings are reassigned, not updated in place: ``torch.cat`` writes
    fresh ``(n, cap)`` tensors and the old ones go back to the caching
    allocator, so residency briefly doubles three rings of a few MB."""
    d = vals.shape[1]
    # forward fill as a gather: each new column takes its own value where
    # filled, else the nearest filled new column before it, else the ring's
    # last column (index 0 of ``src``)
    pos = torch.arange(1, d + 1, device=vals.device).expand_as(mask)
    last = torch.where(mask, pos, 0).cummax(dim=1).values
    new = torch.cat([ring[:, -1:], vals], dim=1).gather(1, last)
    ring = torch.cat([ring[:, d:], new], dim=1)
    filled = torch.cat([filled[:, d:], mask], dim=1)
    ring_t = torch.cat([ring_t[:, d:], tvals], dim=1)
    seen = filled[:, -T:].cumsum(dim=1) > 0
    y_win = torch.where(seen, ring[:, -T:], 0.0)
    return (ring, filled, ring_t, y_win, y_win[:, -warm_s:],
            ring_t[:, -warm_s:])


def _assemble(spec: FeatureSpec, T: int, y_win, temps, cal):
    """Device twin of ``design_matrix`` + ``transform`` over a whole bin:
    ``y_win``/``temps`` (N, T) f32, ``cal`` (T, 5) f32 calendar features
    (computed on the host in float64, then cast once — the cold path's
    cast point). Lag stacking is pure gathering (bitwise the host
    values); per-instance standardization runs in f32 on the device (the
    one place warm and cold differ, at f32 epsilon). Returns the
    standardized X (N, T - warm, F), y, mu and sd."""
    tl, wl = spec.target_lags, spec.weather_lags
    warm = max(tl, wl if spec.use_weather else 0)
    cols = [y_win[:, warm - L: T - L] for L in range(1, tl + 1)]
    if spec.use_weather:
        cols.append(temps[:, warm:])
        cols.extend(temps[:, warm - L: T - L] for L in range(1, wl + 1))
    parts = [torch.stack(cols, dim=-1)]
    if spec.use_calendar:
        parts.append(cal[warm:].expand(y_win.shape[0], T - warm, 5))
    X = torch.cat(parts, dim=-1)
    mu = X.mean(dim=1)
    sd = X.std(dim=1, correction=0) + 1e-8
    return (X - mu[:, None, :]) / sd[:, None, :], y_win[:, warm:], mu, sd


@dataclass
class _BinState:
    key: tuple
    ids: Tuple[str, ...]
    sites: Any                       # weather SiteBatch (fixed per bin)
    spec: FeatureSpec
    T: int                           # window length in steps
    cap: int                         # ring capacity (bucketed >= T)
    n: int
    n_pad: int
    t0: float                        # window start (now - train_window)
    t_hi: float                      # watermark: end of aligned history
    prior: np.ndarray                # per-series store count < t_hi
    ring: Any = None                 # device (n_pad, cap) f32 targets
    filled: Any = None               # device (n_pad, cap) bool
    ring_t: Any = None               # device (n_pad, cap) f32 temperatures
    y_win: Any = None                # device (n_pad, T) f32, window-masked
    y_tail: Any = None               # device (n_pad, warm_s) score window
    t_tail: Any = None               # device (n_pad, warm_s) temp window
    targets_host: Optional[np.ndarray] = None   # f64 rows (cold train path)
    temps_host: Optional[np.ndarray] = None     # f64 rows (cold train path)
    #: (ids(mo), stacked_dev, mu_dev, sd_dev, refs) — refs keep the
    #: matched dicts alive so the id tuple cannot alias recycled objects
    trained: Optional[tuple] = None
    param_cache: Optional[tuple] = None


class FleetRuntime:
    """Owns per-bin device state across polls; created by ``FleetExecutor``
    on the system's device and threaded into ``fleet_train`` /
    ``fleet_score`` of models that set ``SUPPORTS_RUNTIME``. Every public
    entry returns None to send the caller down the unchanged cold path."""

    def __init__(self, system, *, max_states: int = 32,
                 max_delta_steps: int = 512):
        self.system = system
        self.device = system.device
        self.max_states = int(max_states)
        self.max_delta_steps = int(max_delta_steps)
        self._states: "OrderedDict[tuple, _BinState]" = OrderedDict()
        self._no_rollout: set = set()    # (cls, spec) with no device predictor
        self.last_stats: Dict[str, Any] = {}
        # lifetime counters (benchmarks/tests)
        self.cold_loads = 0
        self.warm_loads = 0
        self.invalidations = 0
        self.handoffs = 0                # score bins on the train handoff

    # ------------- telemetry -------------
    def _note(self, mode: str, delta_rows: int, reason: str = "") -> None:
        self.last_stats = {"runtime": mode, "cache_hit": mode == "warm",
                           "delta_rows": delta_rows}
        if reason:
            self.last_stats["runtime_reason"] = reason

    def pop_stats(self) -> Dict[str, Any]:
        out, self.last_stats = self.last_stats, {}
        return out

    # ------------- bin loading -------------
    @staticmethod
    def _merged(cls, instances) -> dict:
        return {**cls.DEFAULTS, **instances[0].user_params}

    def _load(self, cls, instances, up) -> Optional[_BinState]:
        if str(up.get("runtime", "on")).lower() == "off":
            self._note("off", 0)
            return None
        spec = FeatureSpec.from_params(up)
        now = float(up.get("now", 0.0))
        # a bin shares ONE window (executor bins share user_params_key, so
        # the dicts are equal); direct callers mixing nows/params fall
        # back to the cold path (which groups / fails loudly as designed)
        first = instances[0].user_params
        for inst in instances[1:]:
            if inst.user_params != first:
                self._note("cold", 0, "mixed bin params")
                return None
        step = spec.step
        t0 = now - float(up["train_window_days"]) * DAY
        T = regular_grid(t0, now, step).size
        if abs(T * step - (now - t0)) > 1e-6 * step:
            # a window that is not a whole number of steps makes the cold
            # grid origin and the ring watermark live on different bin
            # lattices — stay on the cold path
            self._note("cold", 0, "fractional window")
            return None
        ids = tuple(inst.context.ts_id for inst in instances)
        key = (ids, spec, T)
        state = self._states.get(key)
        if state is not None:
            self._states.move_to_end(key)
            if now == state.t_hi:                       # same-poll re-use
                self._note("warm", 0)
                return state
            if now > state.t_hi:
                k = (now - state.t_hi) / step
                d = int(round(k))
                aligned = d >= 1 and abs(k - d) < 1e-9 * max(1.0, abs(k))
                if aligned and d < min(T, self.max_delta_steps):
                    got = self._advance(state, d, t0, now)
                    if got is not None:
                        self._note("warm", d)
                        return got
                    reason = "late data behind watermark"
                elif aligned:
                    reason = "delta spans window"
                else:
                    reason = "misaligned now"
            else:
                reason = "now regression"
            self.invalidations += 1
            del self._states[key]
        else:
            reason = "first load"
        state = self._build(key, ids, instances, spec, t0, now, T)
        self._note("cold", T, reason)
        return state

    def _advance(self, state: _BinState, d: int, t0: float, now: float
                 ) -> Optional[_BinState]:
        """Watermark-delta poll: one O(log n + delta) store read, one ring
        update on the device. Returns None when a late append
        invalidates."""
        raw, prior = self.system.store.read_many(
            state.ids, end=now, since=state.t_hi, prior_counts=True)
        if not np.array_equal(prior, state.prior):
            return None                 # out-of-order append behind watermark
        vals, mask = align_delta(raw, state.t_hi, now, state.spec.step)
        pad = state.n_pad - state.n
        if state.spec.use_weather:      # observed temps at the d new steps
            tnew = state.sites.temperature(
                state.t_hi + state.spec.step * np.arange(d))
        else:
            tnew = np.zeros((state.n, d))
        dev = self.device
        vals_d, mask_d, tnew_d = (
            torch.as_tensor(edge_pad(a, pad), device=dev)
            for a in (vals.astype(np.float32), mask, tnew.astype(np.float32)))
        warm_s = max(state.spec.target_lags, state.spec.weather_lags) + 1
        (state.ring, state.filled, state.ring_t, state.y_win, state.y_tail,
         state.t_tail) = _update_rings(state.ring, state.filled, state.ring_t,
                                       vals_d, mask_d, tnew_d, state.T,
                                       warm_s)
        state.prior = prior + np.asarray([t.size for t, _ in raw], np.int64)
        state.t0, state.t_hi = t0, now
        state.targets_host = state.temps_host = None   # cold-build only
        self.warm_loads += 1
        return state

    def _build(self, key, ids, instances, spec: FeatureSpec, t0: float,
               now: float, T: int) -> _BinState:
        """Cold build: one full-window batched read (the same one the cold
        path issues) plus one vectorized observed-temperature call;
        host-aligned rows kept in f64 for the cold train path, rings
        uploaded once."""
        from ..obs.trace import get_tracer
        with get_tracer().span("runtime.build", n=len(ids)):
            return self._build_inner(key, ids, instances, spec, t0, now, T)

    def _build_inner(self, key, ids, instances, spec: FeatureSpec,
                     t0: float, now: float, T: int) -> _BinState:
        ctxs = [inst.context for inst in instances]
        grid, targets, mask, prior = fleet_window(
            self.system, ctxs, t0, now, spec.step)
        ents = [c.entity for c in ctxs]
        sites = self.system.weather.sites([e.lat for e in ents],
                                          [e.lon for e in ents])
        n = len(ids)
        temps = sites.temperature(grid) if spec.use_weather \
            else np.zeros((n, T))
        n_pad = bucket_n(n)
        cap = bucket_n(T)
        ring_h = np.zeros((n, cap), np.float32)
        fill_h = np.zeros((n, cap), bool)
        temp_h = np.zeros((n, cap), np.float32)
        ring_h[:, cap - T:] = targets.astype(np.float32)
        fill_h[:, cap - T:] = mask
        temp_h[:, cap - T:] = temps.astype(np.float32)
        ring, filled, ring_t = (
            torch.tensor(edge_pad(a, n_pad - n), device=self.device)
            for a in (ring_h, fill_h, temp_h))
        warm_s = max(spec.target_lags, spec.weather_lags) + 1
        state = _BinState(key=key, ids=ids, sites=sites, spec=spec, T=T,
                          cap=cap, n=n, n_pad=n_pad, t0=t0, t_hi=now,
                          prior=prior, ring=ring, filled=filled,
                          ring_t=ring_t, y_win=ring[:, cap - T:],
                          y_tail=ring[:, cap - warm_s:],
                          t_tail=ring_t[:, cap - warm_s:],
                          targets_host=targets, temps_host=temps)
        self._states[key] = state
        while len(self._states) > self.max_states:
            self._states.popitem(last=False)
        self.cold_loads += 1
        return state

    # ------------- training -------------
    def fleet_xy(self, cls, instances) -> Optional[tuple]:
        """Replacement for ``ForecastModelBase._fleet_xy``: returns
        ``(X, y, mu, sd, state)`` or None (cold path). A freshly built
        state answers with the EXACT host-f64 design-matrix path (single
        polls match the runtime-less executor); warm states assemble on
        the device from the ring."""
        up = self._merged(cls, instances)
        state = self._load(cls, instances, up)
        if state is None:
            return None
        spec, T, n = state.spec, state.T, state.n
        grid = regular_grid(state.t0, state.t_hi, spec.step)
        if state.targets_host is not None:      # cold build this poll
            Xs, ys, mus, sds = [], [], [], []
            for i in range(n):
                X, y = design_matrix(spec, grid, state.targets_host[i],
                                     state.temps_host[i])
                mu, sd = X.mean(0), X.std(0) + 1e-8
                Xs.append((X - mu) / sd)
                ys.append(y), mus.append(mu), sds.append(sd)
            return (np.stack(Xs), np.stack(ys), np.stack(mus),
                    np.stack(sds), state)
        cal = calendar_features(grid) if spec.use_calendar \
            else np.zeros((T, 5))
        X, y, mu, sd = _assemble(
            spec, T, state.y_win, state.ring_t[:, state.cap - T:],
            torch.as_tensor(cal, dtype=torch.float32, device=self.device))
        return X[:n], y[:n], mu[:n], sd[:n], state

    def note_trained(self, state: _BinState, params, mu, sd, out) -> None:
        """Train->score handoff: remember the stacked DEVICE params against
        the identity of the per-instance model objects just persisted, so
        a same-cycle (or any later) score poll of those versions never
        re-uploads or re-stacks them. The dicts themselves ride along in
        the tuple: identity matching is only sound while the matched
        objects are provably alive (a deduplicated retrain discards the
        fresh dicts, and a recycled address must never alias them)."""
        state.trained = (tuple(id(mo) for mo in out), params, mu, sd, out)
        state.param_cache = None

    # ------------- scoring -------------
    def _stacked(self, state: _BinState, model_objects) -> tuple:
        key = tuple(id(mo) for mo in model_objects)
        # id-tuple matching is sound because both caches hold the matched
        # dicts alive (last element), so an id cannot be recycled to a
        # different live object
        if state.param_cache is not None and state.param_cache[0] == key:
            _, stacked, mu, sd, _ = state.param_cache
            return stacked, mu, sd
        if state.trained is not None and state.trained[0] == key:
            _, stacked, mu, sd, _ = state.trained
            self.handoffs += 1
        else:
            stacked, mu, sd = stack_versions(model_objects)
        # bucket-padded once: later warm polls run the rollout without
        # re-stacking or re-padding a parameter
        pad = state.n_pad - state.n
        stacked = {k: edge_pad(v, pad) for k, v in stacked.items()}
        mu, sd = edge_pad(mu, pad), edge_pad(sd, pad)
        state.param_cache = (key, stacked, mu, sd, list(model_objects))
        return stacked, mu, sd

    def fleet_score(self, cls, instances, model_objects) -> Optional[list]:
        """Device-resident scoring: trailing windows come from the ring
        (no store read, no host stacking), params from the train handoff
        or a once-per-version stacking. Returns None to fall back to the
        cold path (runtime off, host rollout requested, no device
        predictor, or a bin the runtime cannot key)."""
        up = self._merged(cls, instances)
        if up.get("rollout", "device") == "host":
            self._note("off", 0, "host rollout requested")
            return None
        if len(model_objects) != len(instances):
            return None
        spec0 = FeatureSpec.from_params(up)
        if (cls, spec0) in self._no_rollout:
            # a host-only model (no device predictor) must not pay ring
            # maintenance AND the cold path every poll
            self._note("off", 0, "no device predictor")
            return None
        state = self._load(cls, instances, up)
        if state is None:
            return None
        spec, n = state.spec, state.n
        H = int(up["horizon"])
        now = state.t_hi
        stacked, mu, sd = self._stacked(state, model_objects)
        # all inputs pre-padded to the shape bucket: the rollout's own
        # bucketing becomes a no-op and the only per-poll host work left
        # is the horizon weather
        fut_t = now + spec.step * np.arange(0, H)
        temps_future = edge_pad(state.sites.forecast(now, fut_t),
                                state.n_pad - n)
        vals = cls._device_rollout(spec, up, stacked, mu, sd, state.y_tail,
                                   state.t_tail, temps_future,
                                   float(fut_t[0]), H, self.device)
        if vals is None:                 # no device predictor: remember
            self._no_rollout.add((cls, spec0))
            return None
        return [(fut_t, vals[i]) for i in range(n)]
