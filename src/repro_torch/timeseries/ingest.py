"""Synthetic IoT ingestion: deterministic smart-grid-like sensor fleets with
irregular sampling (paper §4.1, Fig. 2: ~500 sensors, ~15M readings/month at
the Cyprus site). Generates energy-demand profiles (daily/weekly shape +
temperature response + noise) and instantaneous current feeds for the
Fig.-4 transformation model."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .transforms import DAY, HOUR


@dataclass
class SiteSpec:
    name: str
    n_prosumers: int
    n_feeders: int
    n_substations: int
    seed: int = 0


def demand_profile(rng, times, temperature) -> np.ndarray:
    """kWh per interval: base + daily/weekly shape + temperature response."""
    t = np.asarray(times, np.float64)
    hod = (t % DAY) / HOUR
    dow = ((t // DAY) % 7).astype(np.int64)
    base = rng.uniform(1.0, 6.0)
    morning = np.exp(-0.5 * ((hod - rng.uniform(7, 9)) / 1.5) ** 2)
    evening = np.exp(-0.5 * ((hod - rng.uniform(18, 20)) / 2.0) ** 2)
    weekend = np.where(dow >= 5, rng.uniform(0.7, 0.9), 1.0)
    temp_resp = 0.08 * np.maximum(temperature - 22.0, 0) \
        + 0.05 * np.maximum(16.0 - temperature, 0)
    noise = rng.normal(0, 0.05, size=t.shape)
    return np.maximum(
        base * (0.4 + morning + 1.2 * evening) * weekend + temp_resp + noise, 0.01)


def build_site(castor, spec: SiteSpec, *, t0: float, t1: float,
               step: float = HOUR) -> dict:
    """Create topology + ingest regular energy series for every entity.
    Returns {"contexts": [...], "readings": n}."""
    rng = np.random.default_rng(spec.seed)
    castor.add_signal("ENERGY_LOAD", "kWh", "energy demand per interval")
    castor.add_signal("CURRENT_MAG", "A", "instantaneous current magnitude")
    times = np.arange(t0, t1, step)

    contexts, total = [], 0
    for s in range(spec.n_substations):
        sub = castor.add_entity(f"{spec.name}_SUB_{s}", "SUBSTATION",
                                lat=35.0 + s * 0.01, lon=33.0 + s * 0.01)
        feeders = []
        for f in range(spec.n_feeders):
            fd = castor.add_entity(f"{spec.name}_FD_{s}_{f}", "FEEDER",
                                   lat=sub.lat + 0.001 * f, lon=sub.lon,
                                   parent=sub.name)
            feeders.append(fd)
        agg = np.zeros_like(times)
        for p in range(spec.n_prosumers):
            fd = feeders[p % len(feeders)]
            pr = castor.add_entity(f"{spec.name}_PRO_{s}_{p}", "PROSUMER",
                                   lat=fd.lat + 0.0001 * p, lon=fd.lon,
                                   parent=fd.name)
            temp = castor.weather.temperature(pr.lat, pr.lon, times)
            load = demand_profile(rng, times, temp)
            # irregular raw feed: jitter timestamps, drop ~2%
            keep = rng.random(times.size) > 0.02
            jit = times[keep] + rng.uniform(-0.1, 0.1, keep.sum()) * step
            ts_id = f"raw::{pr.name}::load"
            total += castor.ingest(ts_id, jit, load[keep])
            castor.link(ts_id, "ENERGY_LOAD", pr.name)
            contexts.append(("ENERGY_LOAD", pr.name))
            agg += load
        ts_id = f"raw::{sub.name}::load"
        total += castor.ingest(ts_id, times, agg)
        castor.link(ts_id, "ENERGY_LOAD", sub.name)
        contexts.append(("ENERGY_LOAD", sub.name))
    # bulk ingest done: consolidate so the first fleet read_many is a pure
    # binary-search slice (one sorted segment per series)
    castor.compact()
    seg = castor.store.stats()["segments"]      # store-wide, hence the key
    return {"contexts": contexts, "readings": total, "store_segments": seg}


def ingest_current_feed(castor, entity: str, *, t0: float, t1: float,
                        mean_dt: float = 60.0, seed: int = 3) -> str:
    """One-minute-ish instantaneous current feed (Fig. 4 input)."""
    rng = np.random.default_rng(seed)
    n = int((t1 - t0) / mean_dt)
    times = np.sort(t0 + (t1 - t0) * rng.random(n))
    hod = (times % DAY) / HOUR
    amps = 10 + 6 * np.sin(2 * np.pi * (hod - 7) / 24) ** 2 \
        + rng.normal(0, 0.5, n)
    ts_id = f"raw::{entity}::current"
    castor.ingest(ts_id, times, np.maximum(amps, 0.1))
    castor.link(ts_id, "CURRENT_MAG", entity)
    return ts_id
