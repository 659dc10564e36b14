"""The port's ``Castor`` against the JAX package's, end to end: one small
site, the same JAX-trained ANN versions in both, three hourly fleet score
ticks; persisted forecasts and bands must agree and the port's later ticks
must run on the warm runtime. Then the whole forecast flow: a tick that
trains, scores and detects, held to the JAX Castor's persisted versions,
forecasts and detection records. Also: the port never loads JAX or
``repro``, ``snapshot()``/``stats()`` keep the reference's schema, and the
CPU rehearsal of ``chip_smoke.py``'s phases."""
import importlib.util
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Castor as JaxCastor
from repro.core import Schedule as JaxSchedule
from repro.forecast import ANNForecaster as JaxANN
from repro.forecast.anomaly import BandAnomalyDetector as JaxDetector
from repro.obs.metrics import get_metrics as jax_metrics
from repro.testing import FLEET_ATOL, FLEET_RTOL
from repro.timeseries.ingest import SiteSpec as JaxSiteSpec
from repro.timeseries.ingest import build_site as jax_build_site
from repro_torch.core import Castor, Schedule
from repro_torch.forecast import ANNForecaster, ann_version_from_numpy
from repro_torch.forecast.anomaly import BandAnomalyDetector
from repro_torch.kernels.fleet_mlp import ops
from repro_torch.obs.metrics import get_metrics
from repro_torch.timeseries.ingest import SiteSpec, build_site
from repro_torch.testing import subprocess_env
from repro_torch.timeseries.transforms import DAY, HOUR
from test_torch_train import assert_versions_close, jax_initial_weights

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NOW = 40 * DAY
UP = {"hidden": 16, "epochs": 20, "target_lags": 12, "weather_lags": 2,
      "train_window_days": 14, "horizon": 24}
N_TICKS = 3


def _system(castor, build, spec_cls, schedule_cls, ann):
    build(castor, spec_cls("C", n_prosumers=3, n_feeders=1,
                           n_substations=1, seed=9),
          t0=0.0, t1=NOW + 2 * DAY)
    castor.publish("ann", "1.0", ann)
    deps = castor.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                                 name_prefix="ann", kind="PROSUMER",
                                 score=schedule_cls(NOW, HOUR),
                                 user_params=UP)
    return castor, deps


@pytest.fixture(scope="module")
def run():
    """Both systems after N_TICKS hourly fleet score ticks, with the port's
    per-tick launch deltas and runtime modes."""
    jc, deps = _system(JaxCastor(), jax_build_site, JaxSiteSpec,
                       JaxSchedule, JaxANN)
    tc, _ = _system(Castor(device="cpu"), build_site, SiteSpec, Schedule,
                    ANNForecaster)
    trained_at = NOW - HOUR
    insts = [JaxANN(context=jc.graph.context(d.signal, d.entity),
                    task="train", model_id=d.name, model_version=None,
                    user_params={**UP, "now": trained_at}, system=jc)
             for d in deps]
    for d, mo in zip(deps, JaxANN.fleet_train(insts)):
        jc.versions.save(d.name, mo, trained_at=trained_at)
        tc.versions.save(d.name, ann_version_from_numpy(mo, "cpu"),
                         trained_at=trained_at)
    launches, modes = [], []
    for k in range(N_TICKS):
        now = NOW + k * HOUR
        jres = jc.tick(now, executor="fleet")
        before = ops.invocation_count()
        tres = tc.tick(now, executor="fleet")
        launches.append(ops.invocation_count() - before)
        modes.append([s["runtime"] for s in tc.fleet_executor().last_bin_stats])
        assert len(jres) == len(tres) == len(deps)
        assert all(r.ok for r in jres + tres), \
            [r.error for r in jres + tres if not r.ok]
    return jc, tc, deps, launches, modes


def test_persisted_forecasts_match_jax(run):
    jc, tc, deps, _, _ = run
    for d in deps:
        want = jc.predictions.history(d.name)
        got = tc.predictions.history(d.name)
        assert [f.created_at for f in got] == [f.created_at for f in want] \
            == [NOW + k * HOUR for k in range(N_TICKS)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.times, w.times)
            assert g.model_version == w.model_version
            for a, b in ((g.values, w.values), (g.lower, w.lower),
                         (g.upper, w.upper)):
                np.testing.assert_allclose(a, b, rtol=FLEET_RTOL,
                                           atol=FLEET_ATOL)


def test_later_ticks_are_warm_and_launch_per_step(run):
    _, _, _, launches, modes = run
    assert launches == [24] * N_TICKS           # one bin, 24 horizon steps
    assert modes == [["cold"]] + [["warm"]] * (N_TICKS - 1)


def test_local_executor_matches_fleet(run):
    """The per-instance plain path (LocalPool) persists the same forecasts
    as the fleet path, on a fresh system with the same versions."""
    _, tc, deps, _, _ = run
    lc, _ = _system(Castor(device="cpu"), build_site, SiteSpec, Schedule,
                    ANNForecaster)
    for d in deps:
        mv = tc.versions.get(d.name)
        lc.versions.save(d.name, mv.params, trained_at=mv.trained_at)
    before = ops.invocation_count()
    res = lc.tick(NOW, executor="local")
    assert all(r.ok for r in res) and len(res) == len(deps)
    assert ops.invocation_count() == before     # plain per-instance MLP
    for d in deps:
        got = lc.predictions.latest(d.signal, d.entity)
        want = tc.predictions.history(d.name)[0]
        for a, b in ((got.values, want.values), (got.lower, want.lower),
                     (got.upper, want.upper)):
            np.testing.assert_allclose(a, b, rtol=FLEET_RTOL, atol=FLEET_ATOL)


def test_train_jobs_succeed_and_hand_off_to_scoring():
    """Train jobs run in the port: the versions persist in the port's
    layout, and the same tick's score bin takes the train handoff."""
    c = Castor(device="cpu")
    build_site(c, SiteSpec("C", n_prosumers=3, n_feeders=1,
                           n_substations=1, seed=9), t0=0.0, t1=NOW)
    c.publish("ann", "1.0", ANNForecaster)
    deps = c.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                            name_prefix="tr", kind="PROSUMER",
                            train=Schedule(NOW, DAY),
                            score=Schedule(NOW, HOUR), user_params=UP)
    res = c.tick(NOW)
    assert sorted(r.job.task for r in res) == ["score"] * 3 + ["train"] * 3
    assert all(r.ok for r in res), [r.error for r in res if not r.ok]
    for d in deps:
        mo = c.versions.get(d.name).params
        assert mo["kind"] == "ANN" and mo["mu"].dtype == torch.float32
        assert c.predictions.latest(d.signal, d.entity) is not None
    assert c.fleet_executor().runtime.handoffs == 1
    assert [s["runtime"] for s in c.fleet_executor().last_bin_stats] == \
        ["cold", "warm"]                  # train, then the score bin


MINUTE = 60.0
N_DETECT = 5


def _flow(castor, build, spec_cls, schedule_cls, ann, detector):
    """A forecast fleet that trains and scores at NOW, and a minutely
    detection fleet over the same contexts from NOW + MINUTE."""
    build(castor, spec_cls("D", n_prosumers=3, n_feeders=1,
                           n_substations=1, seed=11),
          t0=0.0, t1=NOW)
    castor.publish("ann", "1.0", ann)
    castor.publish("anom", "1.0", detector)
    deps = castor.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                                 name_prefix="ann", kind="PROSUMER",
                                 train=schedule_cls(NOW, DAY),
                                 score=schedule_cls(NOW, HOUR),
                                 user_params=UP)
    castor.deploy_detections(package="anom", signal="ENERGY_LOAD",
                             name_prefix="d", kind="PROSUMER",
                             detect=schedule_cls(NOW + MINUTE, MINUTE))
    return deps


def _live_feed(jc, deps, rng):
    """Minutely readings around the JAX Castor's NOW forecast (the same
    arrays go to both systems), one sensor spiked far outside its band
    from the window's midpoint on."""
    t = NOW + MINUTE * np.arange(1, N_DETECT + 1)
    feed = {}
    for i, d in enumerate(deps):
        fc = jc.best_forecast(d.signal, d.entity)
        v = np.interp(t, fc.times, fc.values) + rng.normal(0.0, 0.01, t.shape)
        if i == 0:
            v[N_DETECT // 2:] += 25.0
        feed[jc.graph.context(d.signal, d.entity).ts_id] = (t, v)
    return feed


@pytest.fixture(scope="module")
def flow():
    """Both systems after one train + score tick and N_DETECT minutely
    detect ticks, from the same initial weights and the same live feed.
    Both metrics registries are process-global: they start empty, so
    each holds this flow's metrics only, whatever ran before in the
    process."""
    jax_metrics().clear()
    get_metrics().clear()
    jc, tc = JaxCastor(), Castor(device="cpu")
    deps = _flow(jc, jax_build_site, JaxSiteSpec, JaxSchedule, JaxANN,
                 JaxDetector)
    _flow(tc, build_site, SiteSpec, Schedule, ANNForecaster,
          BandAnomalyDetector)
    results = []
    with jax_initial_weights(fleet=True):
        for c in (jc, tc):
            results.append(c.tick(NOW))
    feed = _live_feed(jc, deps, np.random.default_rng(12))
    for c in (jc, tc):
        for ts_id, (t, v) in feed.items():
            c.ingest(ts_id, t, v)
    for k in range(1, N_DETECT + 1):
        for c in (jc, tc):
            results.append(c.tick(NOW + k * MINUTE))
    for res in results:
        assert res and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
    return jc, tc, deps


def test_train_score_detect_tick_matches_jax(flow):
    jc, tc, deps = flow
    for d in deps:
        (want,), (got,) = (c.versions.history(d.name) for c in (jc, tc))
        assert got.trained_at == want.trained_at == NOW
        assert_versions_close(got.params, want.params, "ANN")
        (want,), (got,) = (c.predictions.history(d.name) for c in (jc, tc))
        np.testing.assert_array_equal(got.times, want.times)
        for a, b in ((got.values, want.values), (got.lower, want.lower),
                     (got.upper, want.upper)):
            np.testing.assert_allclose(a, b, rtol=FLEET_RTOL,
                                       atol=FLEET_ATOL)
        want, got = (c.detections.history(f"d-{d.entity}")
                     for c in (jc, tc))
        assert len(got) == len(want) == N_DETECT
        for g, w in zip(got, want):
            assert (g.scheduled_at, g.n_readings, g.band_misses,
                    g.model_version, g.derived_signal) == \
                (w.scheduled_at, w.n_readings, w.band_misses,
                 w.model_version, w.derived_signal)
            assert g.score == pytest.approx(w.score, rel=FLEET_RTOL,
                                            abs=FLEET_ATOL)
    spiked = tc.detections.history(f"d-{deps[0].entity}")
    assert spiked[-1].score > 1.0 and spiked[-1].n_anomalies == 1
    assert tc.stats()["detection"]["records"] == \
        jc.stats()["detection"]["records"] == 3 * N_DETECT


def _detect_bin(c, cls, deps, now):
    insts = [cls(context=c.graph.context(d.signal, d.entity), task="detect",
                 model_id=f"d-{d.entity}", model_version=None,
                 user_params={"now": now}, system=c) for d in deps]
    return insts


def test_detection_records_bitwise_given_the_same_bands(flow):
    """The copied detector: given the JAX Castor's bands, the port's
    ``fleet_detect`` and per-sensor ``detect`` give records bitwise equal
    to the JAX package's ``fleet_detect`` over the same readings."""
    jc, tc, deps = flow
    now = NOW + N_DETECT * MINUTE
    bands = [jc.predictions.latest(d.signal, d.entity, at=now) for d in deps]
    want = JaxDetector.fleet_detect(_detect_bin(jc, JaxDetector, deps, now),
                                    bands)
    insts = _detect_bin(tc, BandAnomalyDetector, deps, now)
    got = BandAnomalyDetector.fleet_detect(insts, bands)
    single = [inst.detect(fc) for inst, fc in zip(insts, bands)]
    assert [vars(r) for r in got] == [vars(r) for r in want] \
        == [vars(r) for r in single]
    assert any(r.score > 0 for r in got)


def test_snapshot_and_stats_keep_the_reference_schema(flow, tmp_path):
    jc, tc, _ = flow

    def schema(d):
        return {k: schema(v) if isinstance(v, dict) else type(v).__name__
                for k, v in d.items()}

    assert schema(tc.stats()) == schema(jc.stats())
    got, want = tc.snapshot(), jc.snapshot()
    assert set(got) == set(want) == {"stats", "metrics", "trace"}
    assert schema(got["stats"]) == schema(want["stats"])
    assert set(got["trace"]) == set(want["trace"])
    assert {k for k in got["metrics"] if not k.startswith("wal.")} <= \
        set(want["metrics"])
    for name in ("store.points", "runtime.cold_loads", "exec.bin_seconds"):
        assert name in got["metrics"]
    path = tc.dump_trace(tmp_path / "trace.json")
    events = __import__("json").loads(Path(path).read_text())["traceEvents"]
    assert {"castor.tick", "exec.bin", "exec.phase.train",
            "exec.phase.detect"} <= {e["name"] for e in events}


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Castor()


def test_port_never_loads_jax_or_repro():
    """A train + score tick of the four forecasters and a detect tick
    (and a version converted from numpy), then a durable serverless train
    + score tick recovered from its log, then the LM training launcher
    (``repro_torch.launch.train --smoke --device cpu --steps 2``) load
    neither JAX nor ``repro``."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.core import Castor, Schedule
        from repro_torch.forecast import PAPER_MODELS, ann_version_from_numpy
        from repro_torch.forecast.anomaly import BandAnomalyDetector
        from repro_torch.timeseries.ingest import SiteSpec, build_site
        from repro_torch.timeseries.transforms import DAY, HOUR
        c = Castor(device="cpu")
        build_site(c, SiteSpec("S", n_prosumers=2, n_feeders=1,
                               n_substations=1, seed=1), t0=0.0, t1=30 * DAY)
        for kind, cls in PAPER_MODELS.items():
            c.publish(kind, "1.0", cls)
            c.deploy_for_all(package=kind, signal="ENERGY_LOAD",
                             name_prefix=kind, kind="PROSUMER",
                             train=Schedule(29 * DAY, DAY),
                             score=Schedule(29 * DAY, HOUR),
                             user_params={"hidden": 4, "epochs": 3,
                                          "horizon": 3,
                                          "train_window_days": 7})
        c.publish("anom", "1.0", BandAnomalyDetector)
        c.deploy_detections(package="anom", signal="ENERGY_LOAD",
                            name_prefix="d", kind="PROSUMER",
                            detect=Schedule(29 * DAY + 60, 60))
        res = c.tick(29 * DAY) + c.tick(29 * DAY + 60)
        assert len(res) == 18 and all(r.ok for r in res), res
        sizes = [54, 4, 4, 4, 4, 1]
        p = {f"w{i}": np.zeros(sizes[i:i + 2]) for i in range(5)}
        p.update({f"b{i}": np.zeros(sizes[i + 1]) for i in range(5)})
        ann_version_from_numpy({"kind": "ANN", "params": {**p, "y_scale": 5.0},
                                "mu": np.zeros(54), "sd": np.ones(54),
                                "y_scale": 4.0, "resid_q": np.zeros(2)},
                               "cpu")
        from repro_torch.serverless import InMemoryStorage
        storage = InMemoryStorage()
        with Castor.open(storage=storage, device="cpu") as d:
            build_site(d, SiteSpec("D", n_prosumers=2, n_feeders=1,
                                   n_substations=1, seed=2),
                       t0=0.0, t1=30 * DAY)
            for kind in ("LR", "ANN"):
                d.publish(kind, "1.0", PAPER_MODELS[kind])
                d.deploy_for_all(package=kind, signal="ENERGY_LOAD",
                                 name_prefix=kind, kind="PROSUMER",
                                 train=Schedule(29 * DAY, DAY),
                                 score=Schedule(29 * DAY, HOUR),
                                 user_params={"hidden": 4, "epochs": 3,
                                              "horizon": 3,
                                              "train_window_days": 7})
            res = d.tick(29 * DAY, executor="serverless")
            assert len(res) == 8 and all(r.ok for r in res), res
        r = Castor.open(storage=storage, device="cpu")
        assert r.versions.count() == 4 and r.predictions.count() == 4
        r.close()
        import tempfile
        from repro_torch.launch import train as launch_train
        with tempfile.TemporaryDirectory() as td:
            losses = launch_train.main(["--smoke", "--device", "cpu",
                                        "--steps", "2",
                                        "--checkpoint-dir", td])
        assert len(losses) == 2 and all(np.isfinite(losses)), losses
        import repro_torch.distributed.compression  # noqa: F401
        import repro_torch.distributed.sharding  # noqa: F401
        import repro_torch.kernels.decode_attention.distributed  # noqa: F401
        import repro_torch.launch.cells  # noqa: F401
        import repro_torch.launch.dryrun  # noqa: F401
        import repro_torch.launch.mesh  # noqa: F401
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code],
                          env=subprocess_env(ROOT / "src"), cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearsal_on_cpu():
    """chip_smoke.py's kernel, training and flow phases at a tiny size
    through the plain versions: the same checks the card run makes. The
    flow's runtime modes, bin by bin and tick by tick, are the JAX
    package's for the same deployments and tick sequence."""
    smoke = _chip_smoke()
    cases = [("scoring", 8, 1, 54, 32, 5, "float32")] + [
        c for c in smoke.KERNEL_CASES if c[0] != "scoring" and c[1] <= 16]
    rec = smoke.kernel_phase("cpu", cases, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    assert set(smoke.train_parity("cpu")) == {"LR", "GAM", "ANN", "LSTM"}
    flow = smoke.forecast_flow("cpu", n_prosumers=4, hidden=16,
                               sub_width=8, epochs=80)
    assert flow["launches"] == 24 * 2 * 3       # ANN fleet + substation
    assert flow["mape_median"] < 30.0
    from repro.core import ModelDeployment as JaxDeployment
    from repro.forecast import EnergyFromCurrentModel as JaxXform
    from repro.forecast import PAPER_MODELS as JAX_MODELS
    from repro.timeseries.ingest import ingest_current_feed
    jm = types.SimpleNamespace(
        Castor=JaxCastor, ModelDeployment=JaxDeployment,
        Schedule=JaxSchedule, PAPER_MODELS=JAX_MODELS,
        EnergyFromCurrentModel=JaxXform, BandAnomalyDetector=JaxDetector,
        SiteSpec=JaxSiteSpec, build_site=jax_build_site,
        ingest_current_feed=ingest_current_feed)
    jc = JaxCastor()
    built = smoke.build_flow(jc, jm, n_prosumers=4, hidden=16, sub_width=8,
                             epochs=2, seed=11)
    ticks = smoke.flow_ticks(jc, 3, 5, built["fleet"], jm, 11)
    assert all(r.ok for t in ticks for r in t["results"])
    assert smoke.tick_modes(ticks) == flow["modes"]


def test_chip_smoke_refuses_to_run_without_card_or_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        if script.parent == ROOT and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
