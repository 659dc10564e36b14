"""The port's ``Castor`` against the JAX package's, end to end: one small
site, the same JAX-trained ANN versions in both, three hourly fleet score
ticks; persisted forecasts and bands must agree and the port's later ticks
must run on the warm runtime. Also: the port never loads JAX or ``repro``,
and the CPU rehearsal of ``chip_smoke.py``'s phases."""
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Castor as JaxCastor
from repro.core import Schedule as JaxSchedule
from repro.forecast import ANNForecaster as JaxANN
from repro.testing import FLEET_ATOL, FLEET_RTOL
from repro.timeseries.ingest import SiteSpec as JaxSiteSpec
from repro.timeseries.ingest import build_site as jax_build_site
from repro_torch.core import Castor, Schedule
from repro_torch.forecast import ANNForecaster, ann_version_from_numpy
from repro_torch.kernels.fleet_mlp import ops
from repro_torch.timeseries.ingest import SiteSpec, build_site
from repro_torch.timeseries.transforms import DAY, HOUR

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


def test_train_job_fails_naming_the_training_slice():
    c, deps = _system(Castor(device="cpu"), build_site, SiteSpec, Schedule,
                      ANNForecaster)
    c.deploy_for_all(package="ann", signal="ENERGY_LOAD", name_prefix="tr",
                     kind="PROSUMER", train=Schedule(NOW, DAY),
                     user_params=UP)
    res = [r for r in c.tick(NOW) if r.job.task == "train"]
    assert len(res) == len(deps)
    assert all(not r.ok and "training slice" in r.error for r in res)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Castor()


def test_port_never_loads_jax_or_repro():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.core import Castor, Schedule
        from repro_torch.forecast import ANNForecaster, ann_version_from_numpy
        from repro_torch.timeseries.ingest import SiteSpec, build_site
        from repro_torch.timeseries.transforms import DAY, HOUR
        c = Castor(device="cpu")
        build_site(c, SiteSpec("S", n_prosumers=2, n_feeders=1,
                               n_substations=1, seed=1), t0=0.0, t1=30 * DAY)
        c.publish("ann", "1.0", ANNForecaster)
        deps = c.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                                name_prefix="a", kind="PROSUMER",
                                score=Schedule(29 * DAY, HOUR),
                                user_params={"hidden": 4, "horizon": 3,
                                             "train_window_days": 7})
        rng = np.random.default_rng(0)
        sizes = [54, 4, 4, 4, 4, 1]
        for d in deps:
            p = {f"w{i}": rng.normal(size=sizes[i:i + 2]) for i in range(5)}
            p.update({f"b{i}": np.zeros(sizes[i + 1]) for i in range(5)})
            p["y_scale"] = 5.0
            mo = {"kind": "ANN", "params": p, "mu": np.zeros(54),
                  "sd": np.ones(54), "y_scale": 4.0,
                  "resid_q": np.array([-0.5, 0.5])}
            c.versions.save(d.name, ann_version_from_numpy(mo, "cpu"),
                            trained_at=0.0)
        res = c.tick(29 * DAY)
        assert len(res) == 2 and all(r.ok for r in res), res
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
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
    """chip_smoke.py's kernel and path phases at a tiny size through the
    plain versions: the same checks the card run makes."""
    smoke = _chip_smoke()
    cases = [("scoring", 8, 1, 54, 32, 5, "float32")] + [
        c for c in smoke.KERNEL_CASES if c[0] != "scoring" and c[1] <= 16]
    rec = smoke.kernel_phase("cpu", cases, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    path = smoke.path_phase("cpu", n_prosumers=4, hidden=16)
    assert path["launches"] == 24 * 3
    assert [t["runtime"] for t in path["ticks"]] == \
        [["cold"], ["warm"], ["warm"]]


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
