"""Time-series transformations (paper §4.1, Fig. 4) + feature engineering
(Table 1): alignment/resampling of irregular feeds, integration of
instantaneous signals into energy, lagged features, calendar features.
Mostly numpy (host-side data prep); the calendar features additionally
ship a torch form (``calendar_features_torch``) so the device-resident
scoring rollout can assemble them on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


def regular_grid(start: float, end: float, step: float) -> np.ndarray:
    """THE binning rule for [start, end) grids — single source of truth for
    ``align_resample`` and the fleet feature path, so per-series rows and
    the shared fleet grid can never disagree on length."""
    nbins = max(int(round((end - start) / step)), 1)
    return start + step * np.arange(nbins)


def align_resample(times, values, *, step: float, start: Optional[float] = None,
                   end: Optional[float] = None, how: str = "mean",
                   with_mask: bool = False):
    """Aggregate an irregular series onto a regular grid [start, end) with
    bin width ``step``. Empty bins are filled by forward-fill (then 0).

    With ``with_mask=True`` additionally returns the boolean fill mask —
    ``mask[j]`` is True where bin j held real points (False bins carry
    forward-filled or zero values). The incremental fleet runtime needs
    the mask to re-derive window-relative fill semantics from a ring
    buffer whose fill sources may have slid out of the current window.
    """
    t = np.asarray(times, np.float64)
    v = np.asarray(values, np.float64)
    if t.size == 0:
        e = np.empty(0)
        return (e, e, np.empty(0, bool)) if with_mask else (e, e)
    start = float(t.min() // step * step) if start is None else start
    end = float(t.max() // step * step + step) if end is None else end
    grid = regular_grid(start, end, step)
    nbins = grid.size
    idx = np.floor((t - start) / step).astype(np.int64)
    ok = (idx >= 0) & (idx < nbins)
    idx, vv = idx[ok], v[ok]
    sums = np.bincount(idx, weights=vv, minlength=nbins)
    cnts = np.bincount(idx, minlength=nbins)
    if how == "sum":
        out = sums                       # empty bins carry zero mass
    else:
        with np.errstate(invalid="ignore"):
            out = np.where(cnts > 0, sums / np.maximum(cnts, 1), np.nan)
        # forward-fill gaps (mean/level signals only — never for sums)
        filled = np.where(cnts > 0)[0]
        if filled.size:
            ffidx = np.maximum.accumulate(
                np.where(cnts > 0, np.arange(nbins), -1))
            out = np.where(ffidx >= 0, out[np.maximum(ffidx, 0)], 0.0)
        else:
            out = np.zeros(nbins)
    if with_mask:
        return grid, out, cnts > 0
    return grid, out


def integrate_to_energy(times, current, *, voltage: float = 230.0,
                        step: float = 900.0) -> Tuple[np.ndarray, np.ndarray]:
    """Fig. 4: instantaneous current magnitude [A] at irregular resolution ->
    energy [kWh] on a regular ``step`` grid (trapezoidal integration of
    P = V*I over each bin)."""
    t = np.asarray(times, np.float64)
    i = np.asarray(current, np.float64)
    if t.size < 2:
        return np.empty(0), np.empty(0)
    order = np.argsort(t)
    t, i = t[order], i[order]
    p_kw = voltage * i / 1000.0                         # kW
    # trapezoid segments, assigned to the bin of their midpoint
    seg_e = 0.5 * (p_kw[1:] + p_kw[:-1]) * np.diff(t) / HOUR   # kWh
    mid = 0.5 * (t[1:] + t[:-1])
    start = float(t[0] // step * step)
    nbins = int((t[-1] - start) // step) + 1
    idx = np.floor((mid - start) / step).astype(np.int64)
    ok = (idx >= 0) & (idx < nbins)
    energy = np.bincount(idx[ok], weights=seg_e[ok], minlength=nbins)
    grid = start + step * np.arange(nbins)
    return grid, energy


def lagged_features(series: np.ndarray, lags) -> np.ndarray:
    """X[t, j] = series[t - lags[j]]; rows with any missing lag are the
    caller's responsibility (first max(lags) rows)."""
    s = np.asarray(series, np.float64)
    lags = list(lags)
    out = np.zeros((s.size, len(lags)))
    for j, L in enumerate(lags):
        out[L:, j] = s[: s.size - L] if L > 0 else s
        out[:L, j] = s[0]
    return out


def calendar_phases(times) -> Tuple[np.ndarray, np.ndarray]:
    """Epoch times -> (hour-of-day 0..24, day-of-week 0..6), float64.

    The modular reduction happens HERE, on the host in float64: epoch
    seconds overflow float32 precision after ~194 days, so a jitted
    (float32) program must receive the reduced phases, never raw times.
    """
    t = np.asarray(times, np.float64)
    return (t % DAY) / HOUR, (t // DAY) % 7


def calendar_features(times) -> np.ndarray:
    """Paper Table 1: time-of-day + week-day features (smooth encodings)."""
    hod, dow = calendar_phases(times)
    feats = [np.sin(2 * np.pi * hod / 24), np.cos(2 * np.pi * hod / 24),
             np.sin(2 * np.pi * dow / 7), np.cos(2 * np.pi * dow / 7),
             (dow >= 5).astype(np.float64)]
    return np.stack(feats, axis=1)


def calendar_features_torch(hod, dow):
    """Torch twin of ``calendar_features`` over pre-reduced phases (see
    ``calendar_phases``): f32 tensors on the rollout's device. Raw epoch
    seconds never reach the device — f32 cannot hold them."""
    import torch
    return torch.stack(
        [torch.sin(2 * math.pi * hod / 24), torch.cos(2 * math.pi * hod / 24),
         torch.sin(2 * math.pi * dow / 7), torch.cos(2 * math.pi * dow / 7),
         (dow >= 5).to(torch.float32)], dim=-1)


def train_val_split(times, values, split_time):
    t = np.asarray(times)
    m = t < split_time
    return (t[m], np.asarray(values)[m]), (t[~m], np.asarray(values)[~m])


def mape(actual, predicted, eps: float = 1e-9) -> float:
    a = np.asarray(actual, np.float64)
    p = np.asarray(predicted, np.float64)
    denom = np.maximum(np.abs(a), eps)
    return float(np.mean(np.abs(a - p) / denom) * 100.0)
