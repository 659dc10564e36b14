"""Synthetic weather service keyed by (lat, lon) — stands in for the paper's
external weather-forecast provider. Deterministic: temperature is a smooth
function of location, season, hour and a location-seeded noise process, so
train/validation reads are reproducible. ``forecast`` adds horizon-dependent
noise to mimic forecast degradation."""
from __future__ import annotations

from typing import Optional

import numpy as np

DAY = 86400.0
YEAR = 365.0 * DAY

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, wrapping uint64)."""
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _counter_normals(keys: np.ndarray, salt: int, idx: np.ndarray
                     ) -> np.ndarray:
    """Standard normals addressed by (site key, salt, position): a
    counter-based generator (splitmix64 -> Box-Muller), so a whole
    fleet's draws vectorize as (N, T) array math instead of N generator
    constructions — generator construction alone dominated steady-state
    fleet polls. Values are deterministic per address and independent of
    batch composition, which keeps the scalar and batched weather reads
    bitwise-identical by construction."""
    c = (keys[:, None] * _GOLD + np.uint64(salt & 0xFFFFFFFFFFFFFFFF)
         + idx.astype(np.uint64) * _M2)
    h1 = _mix64(c * np.uint64(2))
    h2 = _mix64(c * np.uint64(2) + np.uint64(1))
    # 53-bit mantissas -> u1 in (0, 1], u2 in [0, 1)
    u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 1.0) / 2.0 ** 53
    u2 = (h2 >> np.uint64(11)).astype(np.float64) / 2.0 ** 53
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


class WeatherService:
    def __init__(self, seed: int = 7):
        self.seed = seed
        self._params_cache: dict = {}    # per-site generator parameters

    def _key(self, lat: float, lon: float) -> int:
        return (self.seed * 1_000_003 + int(lat * 1e4) * 7919
                + int(lon * 1e4) * 104729) % (2**31 - 1)

    def _site_params(self, lats, lons) -> tuple:
        """Per-site generator parameters, drawn in the SAME per-site rng
        order as the scalar path (one tiny rng per site; the heavy array
        math is what the *_many entry points vectorize). Deterministic per
        site, so they are memoized — rng CONSTRUCTION was the dominant
        cost of a steady-state poll's weather reads."""
        phase = np.empty(len(lats))
        amp_d = np.empty(len(lats))
        amp_y = np.empty(len(lats))
        base = np.empty(len(lats))
        for i, (lat, lon) in enumerate(zip(lats, lons)):
            k = self._key(lat, lon)
            p = self._params_cache.get(k)
            if p is None:
                rng = np.random.default_rng(k)
                p = self._params_cache[k] = (
                    rng.uniform(0, 2 * np.pi), rng.uniform(4, 8),
                    rng.uniform(8, 14), rng.uniform(8, 18))
            phase[i], amp_d[i], amp_y[i], base[i] = p
        return phase[:, None], amp_d[:, None], amp_y[:, None], base[:, None]

    def sites(self, lats, lons) -> "SiteBatch":
        """Precomputed key/parameter arrays for a FIXED fleet of sites.
        The steady-state runtime caches one per bin, so each poll's
        weather reads are pure (N, T) array math — zero per-site python
        on the hot path."""
        return SiteBatch(self, lats, lons)

    def temperature_many(self, lats, lons, times) -> np.ndarray:
        """Batched ``temperature``: ``(N,)`` sites x ``(T,)`` times ->
        ``(N, T)``, bitwise-identical rows to N scalar calls (the per-site
        parameters come from the same draws and the elementwise math
        broadcasts without reassociation)."""
        return self.sites(lats, lons).temperature(times)

    def temperature(self, lat: float, lon: float, times) -> np.ndarray:
        """Actual temperature at given epoch times (deg C)."""
        return self.temperature_many([lat], [lon], times)[0]

    def forecast_many(self, lats, lons, issued_at: float, times, *,
                      draw_len: Optional[int] = None) -> np.ndarray:
        """Batched ``forecast``: one call for a whole fleet bin -> (N, T),
        rows bitwise-identical to N scalar calls (see SiteBatch.forecast
        for the counter-based error and ``draw_len`` semantics)."""
        return self.sites(lats, lons).forecast(issued_at, times,
                                               draw_len=draw_len)

    def forecast(self, lat: float, lon: float, issued_at: float, times) -> np.ndarray:
        """Forecast issued at ``issued_at`` for target ``times``: the truth
        plus error growing with lead time (~0.2 degC/day)."""
        return self.forecast_many([lat], [lon], issued_at, times)[0]


class SiteBatch:
    """Key + generator-parameter arrays for a fixed (lat, lon) fleet.
    Every weather entry point funnels through here, so scalar and batched
    reads cannot drift apart."""

    def __init__(self, service: WeatherService, lats, lons):
        self.keys = np.asarray(
            [service._key(la, lo) for la, lo in zip(lats, lons)], np.uint64)
        self._params = service._site_params(lats, lons)

    def temperature(self, times) -> np.ndarray:
        """Observed temperature (N, T): deterministic elementwise function
        of time per site — slicing the time grid slices the result (the
        observation noise is addressed by the timestamp itself, not by
        array position, so incremental ring appends equal full reads).

        The ~0.3 degC observation noise matters beyond realism: perfectly
        smooth sinusoidal temperatures make a lagged-temperature design
        block nearly rank-deficient, amplifying f32 solver differences
        between the batched and single ridge paths far past the pinned
        executor-equivalence tolerances."""
        t = np.asarray(times, np.float64)
        phase, amp_d, amp_y, base = self._params
        seasonal = amp_y * np.sin(2 * np.pi * t / YEAR + phase)
        diurnal = amp_d * np.sin(2 * np.pi * t / DAY - np.pi / 2)
        slow = 2.0 * np.sin(2 * np.pi * t / (11 * DAY) + phase * 0.7)
        obs = 0.3 * _counter_normals(self.keys, 0x5DEECE66D,
                                     np.round(t).astype(np.int64))
        return base + seasonal + diurnal + slow + obs

    def forecast(self, issued_at: float, times, *,
                 draw_len: Optional[int] = None) -> np.ndarray:
        """Forecast = truth + counter-based error growing with lead time.

        ``draw_len``: when ``times`` is the TRAILING slice of a longer
        ``draw_len``-point grid, the error draws are addressed at their
        full-grid positions, so the result equals
        ``forecast(..., full_grid)[:, -len(times):]`` exactly — a
        steady-state score poll skips the math for history it never reads.

        The error is counter-based (``_counter_normals``): one vectorized
        (N, T) evaluation per fleet bin, deterministic per (site, issue
        time, lead position) and independent of the batch — N per-site
        generator constructions used to dominate the poll.
        """
        t = np.asarray(times, np.float64)
        truth = self.temperature(t)
        lead_days = np.maximum(t - issued_at, 0.0) / DAY
        n_draw = t.size if draw_len is None else int(draw_len)
        idx = np.arange(n_draw - t.size, n_draw)
        err = 0.2 * _counter_normals(self.keys, int(issued_at) % 65521, idx)
        return truth + err * np.sqrt(1.0 + lead_days)
