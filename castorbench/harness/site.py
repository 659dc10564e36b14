"""The site a cell runs on, made from ``--seed``: one energy-demand series
per prosumer, read irregularly (hourly with a jittered timestamp, about 2 %
of readings lost), and the weather the forecasts use (observed
temperatures and forecasts issued at scoring time). The program and the
reference read the same arrays.

The demand and temperature shapes are copies of the program's own
synthetic generators (``timeseries/ingest.py`` ``demand_profile`` and
``timeseries/weather.py``). Each prosumer's constants come from the seed;
the hourly draws come in chunks of ``CHUNK`` hours, chunk ``c`` from the
generator seeded with ``(seed, c)``, made when first asked for: a window
of any length finds its data, and set-up makes only what it reads.
"""
from __future__ import annotations

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR
YEAR = 365.0 * DAY
CHUNK = 256


class Site:
    """``n`` prosumers on hourly slots from ``t_start``: slot h's reading
    at ``t_start + (h + j) HOUR``, ``j`` uniform in [-0.1, 0.1], lost with
    probability 0.02; ``temps``: the observed temperature at each slot's
    hour; ``fc_err``: the standard normal error of a forecast of it."""

    def __init__(self, seed: int, n: int, t_start: float):
        self.seed, self.n, self.t_start = seed, n, float(t_start)
        rng = np.random.default_rng(seed)
        self.lats = 35.0 + 1e-4 * np.arange(n)
        self.lons = np.full(n, 33.0)
        col = (n, 1)
        self.phase = rng.uniform(0, 2 * np.pi, col)
        self.amp_d, self.amp_y = rng.uniform(4, 8, col), rng.uniform(8, 14, col)
        self.base_t = rng.uniform(8, 18, col)
        self.base = rng.uniform(1.0, 6.0, col)
        self.morning = rng.uniform(7, 9, col)
        self.evening = rng.uniform(18, 20, col)
        self.weekend = rng.uniform(0.7, 0.9, col)
        self._chunks = []        # per chunk: (ts, vals, temps, fc_err)
        self._row = {(float(a), float(b)): i
                     for i, (a, b) in enumerate(zip(self.lats, self.lons))}

    def _make(self, c: int):
        rng = np.random.default_rng([self.seed, c])
        shape = (self.n, CHUNK)
        grid = self.t_start + HOUR * (c * CHUNK + np.arange(CHUNK))
        temps = (self.base_t
                 + self.amp_y * np.sin(2 * np.pi * grid / YEAR + self.phase)
                 + self.amp_d * np.sin(2 * np.pi * grid / DAY - np.pi / 2)
                 + 2.0 * np.sin(2 * np.pi * grid / (11 * DAY) + 0.7 * self.phase)
                 + 0.3 * rng.standard_normal(shape))
        fc_err = rng.standard_normal(shape)
        hod = (grid % DAY) / HOUR
        dow = (grid // DAY) % 7
        morning = np.exp(-0.5 * ((hod - self.morning) / 1.5) ** 2)
        evening = np.exp(-0.5 * ((hod - self.evening) / 2.0) ** 2)
        weekend = np.where(dow >= 5, self.weekend, 1.0)
        temp_resp = 0.08 * np.maximum(temps - 22.0, 0) \
            + 0.05 * np.maximum(16.0 - temps, 0)
        vals = np.maximum(self.base * (0.4 + morning + 1.2 * evening) * weekend
                          + temp_resp + rng.normal(0, 0.05, shape), 0.01)
        keep = rng.random(shape) > 0.02
        ts = np.where(keep, grid + rng.uniform(-0.1, 0.1, shape) * HOUR, np.nan)
        return ts, vals, temps, fc_err

    def ensure(self, t: float) -> None:
        """Make every chunk up to the one holding time ``t``."""
        last = int((t - self.t_start) // (HOUR * CHUNK))
        while len(self._chunks) <= last:
            self._chunks.append(self._make(len(self._chunks)))

    def _cols(self, k: int, a: int, b: int) -> np.ndarray:
        """Array ``k`` of every chunk (0 ts, 1 vals, 2 temps, 3 fc_err)
        over slots ``[a, b)``, all rows."""
        self.ensure(self.t_start + HOUR * max(b - 1, 0))
        parts = [self._chunks[c][k][:, max(a - c * CHUNK, 0):
                                    min(b - c * CHUNK, CHUNK)]
                 for c in range(a // CHUNK, (b - 1) // CHUNK + 1)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def readings(self, lo: float, hi: float):
        """``(ts, vals)`` ``(n, k)`` of the slots that may fall in ``[lo,
        hi)``, NaN time where a reading is lost or outside."""
        a = max(int(np.floor((lo - self.t_start) / HOUR)) - 1, 0)
        b = max(int(np.ceil((hi - self.t_start) / HOUR)) + 1, a + 1)
        ts = self._cols(0, a, b)
        with np.errstate(invalid="ignore"):
            inside = (ts >= lo) & (ts < hi)
        return np.where(inside, ts, np.nan), self._cols(1, a, b)

    def hour_index(self, times) -> np.ndarray:
        k = (np.asarray(times, np.float64) - self.t_start) / HOUR
        idx = np.rint(k).astype(np.int64)
        if not (np.all(np.abs(k - idx) < 1e-9) and idx.min() >= 0):
            raise ValueError("weather asked outside the site's hourly grid")
        return idx

    def _at(self, k: int, rows, idx: np.ndarray) -> np.ndarray:
        a = int(idx.min())
        return self._cols(k, a, int(idx.max()) + 1)[np.ix_(rows, idx - a)]

    def temperature(self, rows, times) -> np.ndarray:
        return self._at(2, rows, self.hour_index(times))

    def rows(self, lats, lons) -> np.ndarray:
        return np.asarray([self._row[(float(a), float(b))]
                           for a, b in zip(lats, lons)], np.int64)

    def forecast(self, rows, issued_at: float, times) -> np.ndarray:
        """Forecast of the temperature at ``times`` issued at
        ``issued_at``: the observation plus an error that grows with the
        lead time (0.2 degC at lead 0, times sqrt(1 + lead in days))."""
        idx = self.hour_index(times)
        lead = np.maximum(np.asarray(times, np.float64) - issued_at, 0) / DAY
        return self._at(2, rows, idx) \
            + 0.2 * self._at(3, rows, idx) * np.sqrt(1.0 + lead)


class TableSites:
    """The weather of a fixed set of sites (the interface the program's
    fleet runtime keeps per bin)."""

    def __init__(self, site: Site, lats, lons):
        self.site, self.rows = site, site.rows(lats, lons)

    def temperature(self, times) -> np.ndarray:
        return self.site.temperature(self.rows, times)

    def forecast(self, issued_at: float, times) -> np.ndarray:
        return self.site.forecast(self.rows, issued_at, times)


class TableWeather:
    """A weather provider over the site's tables, with the interface of the
    program's weather service, so the program reads the benchmark's
    weather."""

    def __init__(self, site: Site):
        self.site = site

    def sites(self, lats, lons) -> TableSites:
        return TableSites(self.site, lats, lons)

    def temperature_many(self, lats, lons, times) -> np.ndarray:
        return self.sites(lats, lons).temperature(times)

    def temperature(self, lat, lon, times) -> np.ndarray:
        return self.temperature_many([lat], [lon], times)[0]

    def forecast_many(self, lats, lons, issued_at, times) -> np.ndarray:
        return self.sites(lats, lons).forecast(issued_at, times)

    def forecast(self, lat, lon, issued_at, times) -> np.ndarray:
        return self.forecast_many([lat], [lon], issued_at, times)[0]
