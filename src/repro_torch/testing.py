"""Shared fixtures of the port's fleet, durability and serverless tests:
the steady-state, sharded-fleet and detection systems, the replayable
crash-restart plans, the bitwise store snapshots they are compared by, and
the tolerances.
Every system factory takes ``device=`` (default ``"cuda"``, which raises
without a card; the CPU tests pass ``"cpu"``). A model object that holds tensors is
compared through its numpy image (``forecast.base.version_to_numpy``), so
"bitwise" keeps meaning the same bytes on either device.
"""
from __future__ import annotations

import os

DAY = 86400.0
FLEET_NOW = 35 * DAY

#: forecast agreement across executors, devices and packages: float32
#: batched solves/matmuls reassociate (measured deviations are ~1e-5)
FLEET_RTOL, FLEET_ATOL = 2e-3, 1e-3


def subprocess_env(src_dir) -> dict:
    """Minimal env for a subprocess of the port: the import root and the
    executable path, nothing inherited that could put another package on
    its path."""
    return {"PYTHONPATH": str(src_dir),
            "PATH": os.environ.get("PATH", "/usr/bin:/bin")}


HOUR = 3600.0


def build_steady_castor(kind: str, cls, hp: dict, *, n: int = 6,
                        seed: int = 9, site: str = "Z",
                        train_every: float = 1e12,
                        score_every: float = HOUR, days: int = 38,
                        window_days: int = 14, device="cuda"):
    """Smart-grid fleet for steady-state poll sequences: one ``kind``
    deployment per prosumer (named ``s-{site}_PRO_0_{i}``), first due at
    FLEET_NOW, scoring every ``score_every`` — data pre-ingested through
    ``days`` so successive polls find new window rows. A module-level
    function, so ``functools.partial`` of it is a picklable system factory
    for spawned serverless workers."""
    from .core import Castor, Schedule
    from .timeseries.ingest import SiteSpec, build_site
    c = Castor(device=device)
    build_site(c, SiteSpec(site, n_prosumers=n, n_feeders=1,
                           n_substations=1, seed=seed),
               t0=0.0, t1=days * DAY)
    c.publish(kind, "1.0", cls)
    c.deploy_for_all(package=kind, signal="ENERGY_LOAD", name_prefix="s",
                     kind="PROSUMER", train=Schedule(FLEET_NOW, train_every),
                     score=Schedule(FLEET_NOW, score_every),
                     user_params={"train_window_days": window_days, **hp})
    return c


MINUTE = 60.0


def build_detection_castor(n: int = 3, *, site: str = "D", seed: int = 11,
                           anomaly_sensor: int = 0, minutes: int = 75,
                           days: int = 38, device="cuda"):
    """Forecast fleet + minutely live feed + minutely detection fleet.

    One LR forecast deployment per prosumer is trained AND scored at
    FLEET_NOW (so every context has a banded forecast), then minutely
    readings are ingested over (FLEET_NOW, FLEET_NOW + minutes*MINUTE]:
    in-band noise around the point forecast for every sensor except
    ``anomaly_sensor``, which is spiked far outside any plausible band
    from the window's midpoint on. A ``BandAnomalyDetector`` detection
    deployment (named ``d-{site}_PRO_0_{i}``) is registered per context,
    first due FLEET_NOW + MINUTE, firing every minute."""
    import numpy as np
    from .core import Schedule
    from .forecast import LinearForecaster
    from .forecast.anomaly import BandAnomalyDetector
    c = build_steady_castor("lr", LinearForecaster, {}, n=n, seed=seed,
                            site=site, days=days, device=device)
    res = c.tick(FLEET_NOW, executor="fleet")
    assert res and all(r.ok for r in res), \
        [r.error for r in res if not r.ok]
    rng = np.random.default_rng(seed + 1)
    t = FLEET_NOW + MINUTE * np.arange(1, minutes + 1)
    for i in range(n):
        ent = f"{site}_PRO_0_{i}"
        fc = c.best_forecast("ENERGY_LOAD", ent)
        v = np.interp(t, fc.times, fc.values) \
            + rng.normal(0.0, 0.01, t.shape)
        if i == anomaly_sensor:
            v = v.copy()
            v[minutes // 2:] += 25.0
        c.ingest(c.graph.context("ENERGY_LOAD", ent).ts_id, t, v)
    c.publish("anom", "1.0", BandAnomalyDetector)
    c.deploy_detections(package="anom", signal="ENERGY_LOAD",
                        name_prefix="d", kind="PROSUMER",
                        detect=Schedule(FLEET_NOW + MINUTE, MINUTE))
    return c



def run_polls(c, k: int, *, executor=None, t0: float = FLEET_NOW,
              step: float = HOUR):
    """Run ``k`` consecutive scheduler polls through ``executor`` (default:
    the castor's persistent fleet executor — the runtime-warm path),
    asserting every job succeeds. Returns the executor (its
    ``last_bin_stats`` describe the final poll)."""
    ex = executor if executor is not None else c.fleet_executor()
    for i in range(k):
        res = ex.run(c.scheduler.poll(t0 + i * step))
        assert all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
    return ex

def _canon(obj):
    """Canonical bitwise-comparable form of a params pytree / array: every
    array becomes (dtype, shape, raw bytes), dicts sort by key. A model
    object that holds tensors canonicalizes through ``version_to_numpy``,
    a bare tensor through its numpy image. Two objects canonicalizing
    equal are BITWISE equal — no tolerance anywhere."""
    import numpy as np
    import torch
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict) \
            and any(torch.is_tensor(v) for v in obj["params"].values()):
        from .forecast.base import version_to_numpy
        obj = version_to_numpy(obj)
    if torch.is_tensor(obj):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return ("dict", tuple((k, _canon(v))
                              for k, v in sorted(obj.items())))
    if isinstance(obj, (list, tuple)):
        return ("seq", tuple(_canon(v) for v in obj))
    if hasattr(obj, "dtype") and hasattr(obj, "shape"):
        a = np.asarray(obj)
        return ("arr", str(a.dtype), tuple(a.shape), a.tobytes())
    return ("val", obj)


def snapshot_stores(c) -> dict:
    """Bitwise snapshot of a castor's ModelVersionStore + PredictionStore:
    per deployment, every version's (version, trained_at, params bytes) and
    every forecast's (created_at, model_version, rank, times/values bytes),
    sorted by occurrence stamp so executor completion order cannot leak in.
    Two runs with identical effects produce identical snapshots — the
    exactly-once equivalence surface the chaos suite asserts on."""
    versions = {}
    for name in sorted(getattr(c.versions, "_versions", {})):
        versions[name] = tuple(
            (mv.version, float(mv.trained_at), _canon(mv.params))
            for mv in sorted(c.versions.history(name),
                             key=lambda mv: (mv.trained_at, mv.version)))
    forecasts = {}
    for name in sorted(getattr(c.predictions, "_by_dep", {})):
        forecasts[name] = tuple(
            (float(fc.created_at), fc.model_version, fc.rank, fc.signal,
             fc.entity, _canon(fc.times), _canon(fc.values),
             _canon(fc.lower) if fc.lower is not None else None,
             _canon(fc.upper) if fc.upper is not None else None)
            for fc in sorted(c.predictions.history(name),
                             key=lambda fc: fc.created_at))
    detections = {}
    derived = {}
    det_store = getattr(c, "detections", None)
    if det_store is not None:
        for name in sorted(getattr(det_store, "_by_dep", {})):
            detections[name] = tuple(
                (float(dr.scheduled_at), dr.score, dr.n_readings,
                 dr.n_anomalies, dr.band_misses, dr.model_version,
                 dr.signal, dr.entity, dr.derived_signal)
                for dr in sorted(det_store.history(name),
                                 key=lambda dr: dr.scheduled_at))
            # the derived anomaly series the store wrote back — the
            # exactly-once surface chaos must not double-append to
            for dr in det_store.history(name):
                key = (dr.derived_signal, dr.entity)
                if key not in derived:
                    try:
                        ctx = c.graph.context(*key)
                    except KeyError:
                        continue
                    t, v = c.store.read(ctx.ts_id)
                    derived[key] = (_canon(t), _canon(v))
    return {"versions": versions, "forecasts": forecasts,
            "detections": detections, "derived": derived}


def assert_stores_bitwise_equal(c_ref, c_got, *, context: str = "") -> None:
    """Assert two castors' model-version + prediction stores are bitwise
    identical (same deployments, same occurrences, same params/forecast
    BYTES). Either argument may be a castor or an already-taken
    ``snapshot_stores`` snapshot (the chaos suite caches its fault-free
    baselines that way). Failure messages name the first diverging
    deployment rather than dumping two full snapshots."""
    def _snap(x):
        return x if isinstance(x, dict) and "versions" in x \
            else snapshot_stores(x)
    ref, got = _snap(c_ref), _snap(c_got)
    for kind in ("versions", "forecasts", "detections"):
        rk, gk = ref.get(kind, {}), got.get(kind, {})
        assert set(rk) == set(gk), \
            (f"{context}: {kind} deployment sets differ: "
             f"{sorted(set(rk) ^ set(gk))}")
        for name in rk:
            r, g = rk[name], gk[name]
            assert len(r) == len(g), \
                (f"{context}: {name} has {len(g)} {kind}, expected "
                 f"{len(r)} — duplicate or lost effects")
            for i, (re_, ge) in enumerate(zip(r, g)):
                assert re_ == ge, \
                    (f"{context}: {name} {kind}[{i}] diverges "
                     f"(stamp {ge[0] if ge else '?'} vs {re_[0]})")
    rd, gd = ref.get("derived", {}), got.get("derived", {})
    assert set(rd) == set(gd), \
        (f"{context}: derived-series sets differ: "
         f"{sorted(set(rd) ^ set(gd))}")
    for key in rd:
        assert rd[key] == gd[key], \
            (f"{context}: derived series {key} diverges — a duplicate "
             f"detection double-appended, or one was lost")


# ------------------------------------------------------------ durability
#
# Crash-restart harness: a *plan* is a castor-independent description of
# a workload — semantics, the full external feed, publish/deploy rules,
# and the poll boundaries — captured once from a scratch build. The
# fault-free reference and every recovered castor execute the SAME
# ``drive_plan``, so bitwise comparison isolates exactly what the
# WAL/recovery machinery did. The feed re-sends with at-least-once
# semantics (``replay_feed`` filters by each series' recovered
# ``last_time``): external data cannot be regenerated from a journal, so
# a real deployment's producers would replay it the same way.


def _graph_plan(g):
    signals = [(s.name, s.unit, s.description) for s in g.signals.values()]
    entities = []
    for name, ent in g.entities.items():      # insertion order: parents
        p = g.parent(name)                    # precede their children
        entities.append((ent.name, ent.kind, ent.lat, ent.lon,
                         p.name if p is not None else None))
    links = sorted((tid, s, e) for (s, e), tid in g._ts.items())
    return signals, entities, links


def steady_plan(kind: str, cls, hp: dict, *, n: int = 4, seed: int = 9,
                site: str = "Z", polls: int = 3,
                train_every: float = DAY, score_every: float = HOUR,
                days: int = 38, window_days: int = 14,
                device="cuda") -> dict:
    """Capture a steady-state forecast workload (the
    ``build_steady_castor`` fleet, dailies training + hourly scoring) as
    a replayable plan with ``polls`` hourly boundaries from FLEET_NOW."""
    from .core import Schedule
    scratch = build_steady_castor(kind, cls, hp, n=n, seed=seed, site=site,
                                  train_every=train_every,
                                  score_every=score_every, days=days,
                                  window_days=window_days, device=device)
    signals, entities, links = _graph_plan(scratch.graph)
    feed = {tid: scratch.store.read(tid) for tid in scratch.store.ids()}
    return {
        "signals": signals, "entities": entities, "links": links,
        "feed": feed,
        "publish": [(kind, "1.0", cls)],
        "deploy": [("forecast", dict(
            package=kind, signal="ENERGY_LOAD", name_prefix="s",
            kind="PROSUMER", train=Schedule(FLEET_NOW, train_every),
            score=Schedule(FLEET_NOW, score_every),
            user_params={"train_window_days": window_days, **hp}))],
        "boundaries": [FLEET_NOW + k * score_every for k in range(polls)],
    }


def detection_plan(n: int = 3, *, site: str = "D", seed: int = 11,
                   anomaly_sensor: int = 0, minutes: int = 40,
                   days: int = 38, device="cuda") -> dict:
    """Capture the minutely detection workload
    (``build_detection_castor``: banded LR fleet at FLEET_NOW, minutely
    spiked feed, a BandAnomalyDetector per context) as a replayable plan:
    one FLEET_NOW train+score boundary, then ``minutes`` minutely detect
    boundaries. The minutely readings — a function of the (deterministic)
    FLEET_NOW forecast — are captured as static numbers, so the plan's
    feed is closed under replay."""
    from .core import Schedule
    from .forecast import LinearForecaster
    from .forecast.anomaly import BandAnomalyDetector
    scratch = build_detection_castor(n=n, site=site, seed=seed,
                                     anomaly_sensor=anomaly_sensor,
                                     minutes=minutes, days=days,
                                     device=device)
    signals, entities, links = _graph_plan(scratch.graph)
    feed = {tid: scratch.store.read(tid) for tid in scratch.store.ids()}
    return {
        "signals": signals, "entities": entities, "links": links,
        "feed": feed,
        "publish": [("lr", "1.0", LinearForecaster),
                    ("anom", "1.0", BandAnomalyDetector)],
        "deploy": [
            ("forecast", dict(
                package="lr", signal="ENERGY_LOAD", name_prefix="s",
                kind="PROSUMER", train=Schedule(FLEET_NOW, 1e12),
                score=Schedule(FLEET_NOW, HOUR),
                user_params={"train_window_days": 14})),
            ("detection", dict(
                package="anom", signal="ENERGY_LOAD", name_prefix="d",
                kind="PROSUMER",
                detect=Schedule(FLEET_NOW + MINUTE, MINUTE))),
        ],
        "boundaries": [FLEET_NOW] + [FLEET_NOW + k * MINUTE
                                     for k in range(1, minutes + 1)],
    }


def replay_feed(c, feed) -> int:
    """At-least-once re-ingestion: append only the points past each
    series' recovered ``last_time`` (feeds are time-sorted, so the suffix
    mask is exact; on a fresh castor the whole feed lands). Returns the
    number of points appended."""
    import numpy as np
    total = 0
    for tid in sorted(feed):
        t, v = feed[tid]
        last = c.store.last_time(tid)
        if last is not None:
            keep = np.asarray(t) > last
            t, v = np.asarray(t)[keep], np.asarray(v)[keep]
        if len(t):
            total += c.ingest(tid, t, v)
    return total


def drive_plan(c, plan, *, executor: str = "fleet",
               boundaries=None) -> None:
    """Execute a plan on a castor — fresh OR recovered. Every step is
    idempotent against already-recovered state: semantics re-adds are
    no-ops, the feed replays only its missing suffix, implementations
    re-publish (the registry holds code, which a journal never persists),
    deploy rules skip registered contexts, and boundary ticks re-fire
    only occurrences the recovered watermarks don't already cover."""
    from .core import Signal
    for name, unit, desc in plan["signals"]:
        c.graph.add_signal(Signal(name, unit, desc))
    for name, kind, lat, lon, parent in plan["entities"]:
        c.add_entity(name, kind, lat, lon, parent=parent)
    for tid, sig, ent in plan["links"]:
        c.link(tid, sig, ent)
    replay_feed(c, plan["feed"])
    for package, version, cls in plan["publish"]:
        c.publish(package, version, cls)
    for flow, rule in plan["deploy"]:
        if flow == "detection":
            c.deploy_detections(**rule)
        else:
            c.deploy_for_all(**rule)
    for t in boundaries if boundaries is not None else plan["boundaries"]:
        res = c.tick(t, executor=executor)
        bad = [r.error for r in res if not r.ok]
        assert not bad, bad


def build_fleet_castor(kind: str, cls, hp: dict, mesh_opt: str, *,
                       n: int = 6, seed: int = 9, site: str = "Z",
                       run: bool = True, device="cuda"):
    """Small smart-grid fleet: one ``kind`` deployment per prosumer
    (named ``s-{site}_PRO_0_{i}``), train+score due at FLEET_NOW, with
    ``user_params["mesh"] = mesh_opt``. With ``run`` the due jobs execute
    through a FleetExecutor (asserting success). Returns ``(castor,
    fleet_executor)``."""
    from .core import Castor, Schedule
    from .core.executor import FleetExecutor
    from .timeseries.ingest import SiteSpec, build_site
    c = Castor(device=device)
    build_site(c, SiteSpec(site, n_prosumers=n, n_feeders=1,
                           n_substations=1, seed=seed),
               t0=0.0, t1=38 * DAY)
    c.publish(kind, "1.0", cls)
    c.deploy_for_all(package=kind, signal="ENERGY_LOAD", name_prefix="s",
                     kind="PROSUMER", train=Schedule(FLEET_NOW, 1e12),
                     score=Schedule(FLEET_NOW, 1e12),
                     user_params={"train_window_days": 14,
                                  "mesh": mesh_opt, **hp})
    fx = FleetExecutor(c)
    if run:
        res = fx.run(c.scheduler.poll(FLEET_NOW))
        assert all(r.ok for r in res), [r.error for r in res if not r.ok]
    return c, fx
