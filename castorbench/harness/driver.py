"""The one traffic generator: drives the program's ``Castor.tick`` over a
site made from the seed, as a cell's traffic file sets it.

A traffic file gives the first tick's day (``start_day``), the tick's
step in hours (``tick_hours``), how often the fleet trains and scores
(``train_every_hours``, null: once, at the start; ``score_every_hours``)
and how many set-up ticks warm the cell's shapes (``warmup_ticks``); and,
optionally, the days of history the store holds before the first tick
(``history_days``; default the train window and a day) and the hours of
it that arrived live (``live_hours``; default 0). The configuration gives
the epochs of the set-up's training (``setup_epochs``).

The store is loaded as a long-running deployment holds it: each series's
history in bulk, consolidated, then its last ``k`` hours one hourly append
at a time, ``k`` spread evenly over ``[0, live_hours)`` across the series
(the same set for every seed, dealt to the series by the seed). Each tick
first ingests the readings taken since the last one, then runs
``Castor.tick(now, executor="fleet")`` and waits for the card: the loop
is closed, one tick after another.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .site import DAY, HOUR, Site, TableWeather

SIGNAL = "ENERGY_LOAD"
#: a train schedule that fires once, at its start, within any site here
ONCE_HOURS = 24 * 3650


@dataclass
class Tick:
    now: float
    t0: float                  # host clock: before the ingest
    t_ingested: float          # after the ingest, before Castor.tick
    t_ticked: float            # Castor.tick returned
    t1: float                  # the card synchronised
    trained: int               # train jobs that succeeded
    scored: int                # score jobs that succeeded
    train_jobs: int
    score_jobs: int
    failed: int
    launches: int              # fleet_mlp launches in the tick
    mem_rise: int = 0          # device bytes: the tick's peak over its start
    spans: list = field(default_factory=list)
    fits: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Run:
    cell: object
    device: str
    sizes: List[int]           # the MLP's layer sizes
    rows: int                  # training rows an instance
    setup_s: float = 0.0
    ticks: List[Tick] = field(default_factory=list)
    held_bytes: int = 0        # device bytes held when the window opens
    peak_bytes: int = 0        # the process's peak
    trace: Optional[object] = None     # trace.DeviceTrace of a --trace 1 run
    attempted: int = 0


def user_params(cfg: dict, epochs: int) -> dict:
    return {"hidden": cfg["hidden"], "epochs": int(epochs), "lr": cfg["lr"],
            "train_window_days": cfg["train_window_days"],
            "horizon": cfg["horizon"], "target_lags": cfg["target_lags"],
            "weather_lags": cfg["weather_lags"]}


def layer_sizes(cfg: dict) -> List[int]:
    return [cfg["n_features"]] + [cfg["hidden"]] * cfg["hidden_layers"] + [1]


class Flow:
    """A cell's system: the seed's site, a ``Castor`` on ``device`` that
    reads the site's weather, and one ANN deployment per prosumer."""

    def __init__(self, cell, seed: int, device: str):
        import torch
        from repro_torch.core import Castor
        from repro_torch.forecast.ann import ANNForecaster
        self.cell, self.device = cell, device
        self.laps = [("start", time.perf_counter())]
        cfg, tr = cell.config, cell.traffic
        self.t_first = float(tr["start_day"]) * DAY
        self.step = float(tr["tick_hours"]) * HOUR
        t_start = self.t_first - tr.get(
            "history_days", cfg["train_window_days"] + 1) * DAY
        self.site = Site(seed, cfg["n_prosumers"], t_start)
        self.lap("site")
        self.sync = torch.cuda.synchronize if device != "cpu" else (
            lambda: None)
        c = self.castor = Castor(device=device)
        c.weather = TableWeather(self.site)
        c.add_signal(SIGNAL, "kWh", "energy demand per interval")
        self.ts_ids = []
        for i in range(self.site.n):
            name = f"SITE_P{i:05d}"
            c.add_entity(name, "PROSUMER", lat=float(self.site.lats[i]),
                         lon=float(self.site.lons[i]))
            ts_id = f"raw::{name}::load"
            c.link(ts_id, SIGNAL, name)
            self.ts_ids.append(ts_id)
        self.load_history(seed, int(tr.get("live_hours", 0)))
        c.publish("ann", "1.0", ANNForecaster)
        self.deployments = self.deploy(cfg["setup_epochs"])
        self.ticks_run = 0
        self.lap("system")

    def lap(self, label: str) -> None:
        self.laps.append((label, time.perf_counter()))

    def deploy(self, epochs: int):
        tr = self.cell.traffic
        from repro_torch.core import Schedule
        every = tr["train_every_hours"] or ONCE_HOURS
        return self.castor.deploy_for_all(
            package="ann", signal=SIGNAL, name_prefix="ann", kind="PROSUMER",
            train=Schedule(self.t_first, every * HOUR),
            score=Schedule(self.t_first, tr["score_every_hours"] * HOUR),
            user_params=user_params(self.cell.config, epochs))

    def redeploy(self, epochs: int) -> None:
        """The same deployments with another number of epochs."""
        for d in self.deployments:
            self.castor.undeploy(d.name)
        self.deployments = self.deploy(epochs)

    def load_history(self, seed: int, live_hours: int) -> None:
        """The store up to the first tick: series ``i``'s history up to
        ``k_i`` hours before it in one append, consolidated, then those
        hours one append an hour (module docstring)."""
        n = self.site.n
        k = np.random.default_rng([seed, 11]).permutation(
            np.arange(n) * live_hours // n)
        ts, vals = self.site.readings(self.site.t_start, self.t_first)
        with np.errstate(invalid="ignore"):
            bulk = ts < self.t_first - k[:, None] * HOUR
        self._append(np.where(bulk, ts, np.nan), vals, np.arange(n))
        self.castor.compact()
        for h in range(live_hours, 0, -1):
            lo = self.t_first - h * HOUR
            rows = np.nonzero(k >= h)[0]
            ts, vals = self.site.readings(lo, lo + HOUR)
            self._append(ts[rows], vals[rows], rows)
        self.ingested_to = self.t_first

    def _append(self, ts, vals, rows) -> None:
        """One append per row of ``ts`` that has a reading (not NaN), to
        the series ``rows``."""
        cnt = np.isfinite(ts).sum(axis=1)
        order = np.argsort(ts, axis=1, kind="stable")      # NaN last
        ts = np.take_along_axis(ts, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        ids, ingest = self.ts_ids, self.castor.ingest
        for i in np.nonzero(cnt)[0].tolist():
            ingest(ids[rows[i]], ts[i, :cnt[i]], vals[i, :cnt[i]])

    def ingest(self, now: float) -> None:
        """Every reading taken in ``[last ingest, now)``, one append per
        series that has any."""
        ts, vals = self.site.readings(self.ingested_to, now)
        self._append(ts, vals, np.arange(self.site.n))
        self.ingested_to = now

    def tick(self, *, spans: bool = False) -> Tick:
        from repro_torch.kernels.fleet_mlp import ops
        now = self.t_first + self.ticks_run * self.step
        # the readings and weather the tick reads, made before its clock
        self.site.ensure(now + (self.cell.config["horizon"] + 1) * HOUR)
        tracer = self.castor.tracer
        tracer.clear()
        launches = ops.invocation_count()
        t0 = time.perf_counter()
        self.ingest(now)
        t_ingested = time.perf_counter()
        results = self.castor.tick(now, executor="fleet")
        t_ticked = time.perf_counter()
        self.sync()
        t1 = time.perf_counter()
        self.ticks_run += 1
        ok_tasks = [r.job.task for r in results if r.ok]
        tasks = [r.job.task for r in results]
        return Tick(now=now, t0=t0, t_ingested=t_ingested, t_ticked=t_ticked,
                    t1=t1, trained=ok_tasks.count("train"),
                    scored=ok_tasks.count("score"),
                    train_jobs=tasks.count("train"),
                    score_jobs=tasks.count("score"),
                    failed=sum(not r.ok for r in results),
                    launches=ops.invocation_count() - launches,
                    spans=tracer.spans() if spans else [])

    def setup(self) -> None:
        """The set-up ticks, then the config's epochs where the window
        trains."""
        tr = self.cell.traffic
        for k in range(tr["warmup_ticks"]):
            rec = self.tick()
            if rec.failed:
                raise RuntimeError(f"{rec.failed} jobs failed in set-up")
            self.lap(f"set-up tick {k + 1}")
        cfg = self.cell.config
        if tr["train_every_hours"] and cfg["setup_epochs"] != cfg["epochs"]:
            self.redeploy(cfg["epochs"])


class FitTap:
    """Wraps each call of the program's fit (``forecast/ann.py``'s
    ``fit_adam``) in the window: keeps the loss of its first
    ``LOSS_STEPS`` steps as the fit computed it (the check compares them,
    ``check.fit_loss``), and with ``timed`` CUDA events around the call
    (``fit_roofline``). The cost is a Python call a step."""

    LOSS_STEPS = 3

    def __init__(self, timed: bool):
        self.timed, self.fits, self._orig = timed, [], None

    def __enter__(self):
        import torch
        from repro_torch.forecast import ann
        self._orig = orig = ann.fit_adam

        def tapped(params, loss_fn, epochs, lr):
            rec = {"n": next(iter(params.values())).shape[0],
                   "epochs": epochs, "losses": []}

            def loss(p):
                out = loss_fn(p)
                if len(rec["losses"]) < self.LOSS_STEPS:
                    rec["losses"].append(out.detach().clone())
                return out

            if self.timed:
                ev = rec["events"] = [torch.cuda.Event(enable_timing=True)
                                      for _ in range(2)]
                ev[0].record()
            out = orig(params, loss, epochs, lr)
            if self.timed:
                ev[1].record()
            self.fits.append(rec)
            return out

        ann.fit_adam = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.forecast import ann
        ann.fit_adam = self._orig
        return False

    def take(self) -> list:
        """The fits since the last call, their losses as floats (after
        the tick's synchronise)."""
        out, self.fits = self.fits, []
        for f in out:
            f["losses"] = [float(v) for v in f["losses"]]
            if "events" in f:
                a, b = f.pop("events")
                f["device_s"] = a.elapsed_time(b) / 1e3
        return out


def run_window(flow: Flow, run: Run, seconds: float, trace: bool) -> None:
    """Ticks, one after another, until ``seconds`` have passed; the tick
    in flight at the deadline finishes and counts (so there is at least
    one). Each tick's device memory is read from its start to its end.
    With ``trace``, the profiler records the card, the fits are timed and
    the program's spans are kept."""
    import torch
    from . import trace as trace_mod
    cuda = flow.device != "cpu"
    if cuda:
        run.held_bytes = torch.cuda.memory_allocated()
    prof = None
    tap = FitTap(timed=trace and cuda).__enter__()
    if trace:
        prof = trace_mod.DeviceRecorder(cuda).start()
    t_start = time.perf_counter()
    try:
        while True:
            if cuda:
                run.peak_bytes = max(run.peak_bytes,
                                     torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            rec = flow.tick(spans=trace)
            if cuda:
                rec.mem_rise = torch.cuda.max_memory_allocated() - base
            rec.fits = tap.take()
            run.ticks.append(rec)
            if time.perf_counter() - t_start >= seconds:
                break
    finally:
        tap.__exit__()
    if prof is not None:
        run.trace = prof.stop(time.perf_counter())
    if cuda:
        run.peak_bytes = max(run.peak_bytes, torch.cuda.max_memory_allocated())
    run.attempted = sum(t.train_jobs + t.score_jobs for t in run.ticks)
