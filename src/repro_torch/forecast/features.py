"""Feature engineering per paper Table 1, expressed against semantic concepts:
the model code asks for (context.signal, context.entity) history and weather
at (entity.lat, entity.lon) — never for raw sensor ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.metrics import note_retrace
from ..timeseries.transforms import (HOUR, align_resample, calendar_features,
                                     calendar_features_torch, lagged_features,
                                     regular_grid)

# ---------------------------------------------------------------------------
# Trace accounting, kept so the executor's per-bin stats keep their keys:
# a compiled hot-path program would increment the counter in its Python
# body, which runs only while the program is traced, so ``trace_count()``
# deltas count (re)compilations (``FleetExecutor.last_bin_stats
# ["retraces"]``). Eager PyTorch traces nothing: on this path the counter
# stays at 0.
# ---------------------------------------------------------------------------
_TRACE_COUNT = 0


def note_trace(name: str = "features") -> None:
    global _TRACE_COUNT
    _TRACE_COUNT += 1
    note_retrace(name)


def trace_count() -> int:
    return _TRACE_COUNT


# ---------------------------------------------------------------------------
# Shape bucketing: fleet bins of nearby sizes share one shape.
# ---------------------------------------------------------------------------

def bucket_n(n: int) -> int:
    """Power-of-two bucket for a fleet bin's instance axis (and the runtime
    ring's history axis): padding N up to the bucket gives nearby bin
    sizes one set of tensor shapes, so a bin that shrinks by one job (a
    failed deployment, a removed sensor) keeps the shapes of its device
    state."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def edge_pad(a, pad: int, axis: int = 0):
    """Pad ``axis`` by repeating the trailing slice ``pad`` times. Edge
    replication — never zeros — so padded instances run the same numerics
    as a real one; callers slice the pad back off every output. Works on
    numpy arrays and torch tensors (the result stays on the tensor's
    device)."""
    if pad <= 0:
        return a
    take = [slice(None)] * a.ndim
    take[axis] = slice(a.shape[axis] - 1, a.shape[axis])
    shape = list(a.shape)
    shape[axis] = pad
    if isinstance(a, np.ndarray):
        return np.concatenate(
            [a, np.broadcast_to(a[tuple(take)], shape)], axis=axis)
    return torch.cat([a, a[tuple(take)].expand(shape)], dim=axis)


@dataclass(frozen=True)
class FeatureSpec:
    target_lags: int = 24        # 1..L hourly lags of the target
    weather_lags: int = 24       # 1..Lw hourly lags of temperature
    use_weather: bool = True
    use_calendar: bool = True
    step: float = HOUR

    @property
    def n_features(self) -> int:
        n = self.target_lags
        if self.use_weather:
            n += 1 + self.weather_lags
        if self.use_calendar:
            n += 5
        return n

    @classmethod
    def from_params(cls, up: dict) -> "FeatureSpec":
        return cls(target_lags=int(up.get("target_lags", 24)),
                   weather_lags=int(up.get("weather_lags", 24)),
                   use_weather=bool(up.get("use_weather", True)),
                   use_calendar=bool(up.get("use_calendar", True)),
                   step=float(up.get("frequency", HOUR)))


def fleet_hourly_series(system, ctxs, t0: float, t1: float,
                        step: float) -> Tuple[np.ndarray, np.ndarray]:
    """Batched series loading: ONE ``store.read_many`` for a whole fleet
    bin, then per-series alignment onto the shared ``[t0, t1)`` grid.

    Returns ``(grid (T,), targets (N, T))``; rows align 1:1 with ``ctxs``.

    Missing-data policy (deliberate, see docs/ARCHITECTURE.md): a window
    with NO points yields an all-zero row, so the job succeeds with flat
    forecasts in both executors instead of crashing — one dead sensor
    must not poison a megabatched bin, and LocalPool must agree with
    Fleet. ``hourly_series`` is the single-context case of this function,
    so the solo and fleet paths cannot drift apart.
    """
    raw = system.store.read_many([c.ts_id for c in ctxs],
                                 t0 - step, t1 + step)
    grid = regular_grid(t0, t1, step)   # same binning rule as align_resample
    rows = []
    for t, v in raw:
        if t.size == 0:
            rows.append(np.zeros_like(grid))
            continue
        _, r = align_resample(t, v, step=step, start=t0, end=t1)
        rows.append(r)
    return grid, np.stack(rows) if rows else np.zeros((0, grid.size))


def hourly_series(system, ctx, t0: float, t1: float, step: float) -> Tuple[np.ndarray, np.ndarray]:
    grid, targets = fleet_hourly_series(system, [ctx], t0, t1, step)
    return grid, targets[0]


def fleet_window(system, ctxs, t0: float, t1: float, step: float):
    """``fleet_hourly_series`` plus the two extras the incremental runtime
    needs to keep a bin's history device-resident across polls:

    * ``mask (N, T)`` — which grid bins held real points (the others carry
      window-relative forward-fill / leading-zero values);
    * ``prior (N,)`` — per-series count of stored points strictly before
      the read window, taken under the SAME store lock as the read, so a
      later ``read_many(since=watermark)`` can prove no out-of-order
      append landed behind the watermark.

    Returns ``(grid, targets, mask, prior)``; rows computed by the exact
    ``align_resample`` rule, so ``targets`` equals what the cold path
    loads.
    """
    raw, prior = system.store.read_many([c.ts_id for c in ctxs],
                                        t0 - step, t1 + step,
                                        prior_counts=True)
    grid = regular_grid(t0, t1, step)
    rows, masks = [], []
    in_window = np.zeros(len(raw), np.int64)   # points < t1 (next watermark)
    for i, (t, v) in enumerate(raw):
        if t.size == 0:
            rows.append(np.zeros_like(grid))
            masks.append(np.zeros(grid.size, bool))
            continue
        in_window[i] = int(np.searchsorted(t, t1)) \
            - int(np.searchsorted(t, t0 - step))
        _, r, m = align_resample(t, v, step=step, start=t0, end=t1,
                                 with_mask=True)
        rows.append(r)
        masks.append(m)
    # prior counts from the store are "< t0 - step"; the runtime watermark
    # is t1, so fold in the returned points below it (same lock => exact)
    prior = prior + in_window
    if not rows:
        z = np.zeros((0, grid.size))
        return grid, z, z.astype(bool), prior
    return grid, np.stack(rows), np.stack(masks), prior


def align_delta(raw, t_hi: float, t1: float, step: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Align a watermark-delta read onto the ``d`` new grid bins covering
    ``[t_hi, t1)``: returns ``(vals (N, d), mask (N, d))`` where ``vals``
    holds each filled bin's mean (same bincount rule as
    ``align_resample``) and ``mask`` marks filled bins. Empty bins are
    left 0 here — the device ring update forward-fills them from the
    previous ring column, which by induction carries the value
    ``align_resample`` would have propagated."""
    d = max(int(round((t1 - t_hi) / step)), 0)
    n = len(raw)
    sizes = np.asarray([t.size for t, _ in raw], np.int64)
    if sizes.sum() == 0:
        return np.zeros((n, d)), np.zeros((n, d), bool)
    # one flattened bincount over (series, bin) — per-(series,bin) sums
    # accumulate in the same store order as align_resample's, so filled
    # bins land bitwise-identical to the cold aligner
    tcat = np.concatenate([t for t, _ in raw if t.size])
    vcat = np.concatenate([v for _, v in raw if v.size])
    sidx = np.repeat(np.arange(n), sizes)
    idx = np.floor((tcat - t_hi) / step).astype(np.int64)
    ok = (idx >= 0) & (idx < d)
    flat = sidx[ok] * d + idx[ok]
    sums = np.bincount(flat, weights=vcat[ok], minlength=n * d).reshape(n, d)
    cnts = np.bincount(flat, minlength=n * d).reshape(n, d)
    mask = cnts > 0
    vals = np.where(mask, sums / np.maximum(cnts, 1), 0.0)
    return vals, mask


def design_matrix(spec: FeatureSpec, times, target, temps) -> Tuple[np.ndarray, np.ndarray]:
    """Rows t -> predict target[t] from lags/calendar/weather. Drops warmup."""
    cols = [lagged_features(target, range(1, spec.target_lags + 1))]
    if spec.use_weather:
        cols.append(temps[:, None])
        cols.append(lagged_features(temps, range(1, spec.weather_lags + 1)))
    if spec.use_calendar:
        cols.append(calendar_features(times))
    X = np.concatenate(cols, axis=1)
    warm = max(spec.target_lags, spec.weather_lags if spec.use_weather else 0)
    return X[warm:], np.asarray(target, np.float64)[warm:]


def step_features(spec: FeatureSpec, y_hist: np.ndarray, temp_hist: np.ndarray,
                  t_next: float) -> np.ndarray:
    """Feature row(s) for ONE next step given trailing history.
    y_hist/temp_hist: (..., >=lags) trailing windows (last element = t-1)."""
    tl, wl = spec.target_lags, spec.weather_lags
    cols = [y_hist[..., -1: -tl - 1: -1]]              # lag1..lagL
    if spec.use_weather:
        cols.append(temp_hist[..., -1:])               # temp at ~t (forecast)
        cols.append(temp_hist[..., -2: -wl - 2: -1])
    if spec.use_calendar:
        cal = calendar_features(np.asarray([t_next]))[0]
        cal = np.broadcast_to(cal, y_hist.shape[:-1] + (5,))
        cols.append(cal)
    return np.concatenate(cols, axis=-1)


def recursive_forecast(predict_fn, spec: FeatureSpec, y_hist, temp_hist,
                       temps_future, t_start: float, horizon: int):
    """Roll a one-step model forward ``horizon`` steps (recursive strategy).
    Vectorised over leading dims: y_hist (..., L), temps_future (..., H).
    predict_fn maps (..., F) -> (...,). Returns (..., H).

    This is the host-side REFERENCE path: one predict_fn round-trip per
    step. The serving hot path is ``make_device_rollout``, which runs the
    identical recursion on the device with no host round-trip inside the
    horizon; ``tests/test_torch_forecast.py`` pins their agreement.
    """
    y_hist = np.array(y_hist, np.float64)
    temp_hist = np.array(temp_hist, np.float64)
    preds = []
    for h in range(horizon):
        t_next = t_start + h * spec.step
        temp_hist = np.concatenate(
            [temp_hist, temps_future[..., h: h + 1]], axis=-1)
        x = step_features(spec, y_hist, temp_hist, t_next)
        yh = np.asarray(predict_fn(x), np.float64)
        preds.append(yh)
        y_hist = np.concatenate([y_hist, yh[..., None]], axis=-1)
    return np.stack(preds, axis=-1)


def step_features_torch(spec: FeatureSpec, y_win, t_win, cal_row):
    """Torch twin of ``step_features`` over FIXED-SIZE trailing windows:
    y_win (..., target_lags) with the most recent value last, t_win
    (..., weather_lags+1) already including the step's forecast temp at
    its end, cal_row (5,) precomputed calendar features for the step."""
    wl = spec.weather_lags
    cols = [y_win.flip(-1)]                            # lag1..lagL
    if spec.use_weather:
        cols.append(t_win[..., -1:])                   # temp at ~t (forecast)
        if wl:
            cols.append(t_win[..., :-1].flip(-1))      # lag1..lagW
    if spec.use_calendar:
        cols.append(cal_row.expand(y_win.shape[:-1] + (5,)))
    return torch.cat(cols, dim=-1)


def make_device_rollout(predict_fn, spec: FeatureSpec, horizon: int):
    """Device-resident whole-horizon rollout: a plain Python loop over the
    horizon whose every step — feature assembly, per-instance
    standardization, prediction, window roll — runs on the inputs' device.
    The host loop in ``recursive_forecast`` crosses host<->device twice per
    step; this crosses once per score bin (the final copy of the (N, H)
    predictions).

    The lag and temperature windows are views into two buffers laid out
    along time, ``[history | horizon]``: step ``h`` reads
    ``y_buf[:, h:h+L]`` and writes its prediction at ``y_buf[:, L+h]``,
    so no window is rebuilt per step and the predictions are the buffer's
    tail.

    predict_fn: (stacked_params, x (N, F)) -> (N,) predictions
    (standardized features in, physical-unit predictions out).

    Returns ``run(stacked, mu, sd, y0, tw0, temps_future, hod, dow)``
      stacked       dict of per-instance model params, leading dim N
      mu, sd        (N, F) per-instance feature standardization
      y0            (N, target_lags) trailing target window, newest last
      tw0           (N, weather_lags+1) trailing temperature window
      temps_future  (N, H) weather forecasts for the horizon
      hod, dow      (H,) calendar phases (``calendar_phases`` of the
                    horizon timestamps — reduced on host, f32-safe)
    -> (N, H) predictions, on the inputs' device.
    """
    tl, wl = spec.target_lags, spec.weather_lags

    def run(stacked, mu, sd, y0, tw0, temps_future, hod, dow):
        cal = calendar_features_torch(hod, dow)                  # (H, 5)
        n = y0.shape[0]
        y_buf = torch.cat([y0, y0.new_zeros(n, horizon)], dim=1)
        t_buf = torch.cat([tw0, temps_future], dim=1) if spec.use_weather \
            else tw0
        for h in range(horizon):
            y_win = y_buf[:, h:h + tl]
            t_win = t_buf[:, h + 1:h + wl + 2] if spec.use_weather else t_buf
            x = step_features_torch(spec, y_win, t_win, cal[h])
            y_buf[:, tl + h] = predict_fn(stacked, (x - mu) / sd)
        return y_buf[:, tl:]

    return run
