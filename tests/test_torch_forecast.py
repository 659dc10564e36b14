"""The port's ANN scoring half against the JAX package's: the same site,
the same JAX-trained versions (handed to the port through
``ann_version_from_numpy``), scored by both ``fleet_score``s; and the
port's device rollout against its own host ``recursive_forecast``."""
import numpy as np
import pytest
import torch

from repro.core import Castor as JaxCastor
from repro.forecast import ANNForecaster as JaxANN
from repro.testing import FLEET_ATOL, FLEET_RTOL
from repro.timeseries.ingest import SiteSpec as JaxSiteSpec
from repro.timeseries.ingest import build_site as jax_build_site
from repro_torch.core import Castor
from repro_torch.forecast import ANNForecaster, ann_version_from_numpy
from repro_torch.kernels.fleet_mlp import ops
from repro_torch.timeseries.ingest import SiteSpec, build_site
from repro_torch.timeseries.transforms import DAY

torch.set_num_threads(1)

NOW = 40 * DAY
ENTS = ["F_PRO_0_0", "F_PRO_0_1", "F_PRO_0_2", "F_PRO_0_3"]
HP = {"hidden": 16, "epochs": 20, "target_lags": 12, "weather_lags": 2,
      "train_window_days": 14}


def _site(castor, build, spec_cls):
    build(castor, spec_cls("F", n_prosumers=4, n_feeders=1,
                           n_substations=1, seed=5),
          t0=0.0, t1=NOW + 2 * DAY)
    return castor


@pytest.fixture(scope="module")
def systems():
    return (_site(JaxCastor(), jax_build_site, JaxSiteSpec),
            _site(Castor(device="cpu"), build_site, SiteSpec))


def _instances(c, cls, extra=None):
    up = {**HP, "now": NOW, **(extra or {})}
    return [cls(context=c.graph.context("ENERGY_LOAD", e), task="score",
                model_id=f"f-{e}", model_version=None, user_params=up,
                system=c) for e in ENTS]


@pytest.fixture(scope="module")
def versions(systems):
    """JAX-trained versions and the port's conversions of them."""
    jc, _ = systems
    jax_mos = JaxANN.fleet_train(_instances(jc, JaxANN))
    return jax_mos, [ann_version_from_numpy(m, "cpu") for m in jax_mos]


def _assert_forecasts_close(got, want):
    for (gt, gv, gl, gu), (wt, wv, wl, wu) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        for g, w in ((gv, wv), (gl, wl), (gu, wu)):
            np.testing.assert_allclose(g, w, rtol=FLEET_RTOL, atol=FLEET_ATOL)


@pytest.mark.parametrize("rollout", ["device", "host"])
def test_fleet_score_matches_jax(systems, versions, rollout):
    jc, tc = systems
    jax_mos, port_mos = versions
    extra = {"rollout": rollout}
    want = JaxANN.fleet_score(_instances(jc, JaxANN, extra), jax_mos)
    before = ops.invocation_count()
    got = ANNForecaster.fleet_score(_instances(tc, ANNForecaster, extra),
                                    port_mos)
    # one fleet_mlp call per horizon step on either rollout
    assert ops.invocation_count() - before == 24
    assert len(got) == len(ENTS)
    _assert_forecasts_close(got, want)


def test_device_rollout_matches_host_recursion(systems, versions):
    _, tc = systems
    _, port_mos = versions
    device = ANNForecaster.fleet_score(_instances(tc, ANNForecaster),
                                       port_mos)
    host = ANNForecaster.fleet_score(
        _instances(tc, ANNForecaster, {"rollout": "host"}), port_mos)
    _assert_forecasts_close(device, host)


def test_single_score_matches_fleet(systems, versions):
    """The per-instance plain path (LocalPool's) equals the fleet path."""
    _, tc = systems
    _, port_mos = versions
    insts = _instances(tc, ANNForecaster)
    fleet = ANNForecaster.fleet_score(insts, port_mos)
    single = [inst.score(mo) for inst, mo in zip(insts, port_mos)]
    _assert_forecasts_close(single, fleet)


def test_version_round_trip(versions):
    jax_mos, port_mos = versions
    for jm, pm in zip(jax_mos, port_mos):
        assert pm["kind"] == "ANN"
        assert set(pm["params"]) == set(jm["params"])
        for k, v in jm["params"].items():
            t = pm["params"][k]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(v, np.float32))
        for k in ("mu", "sd"):
            np.testing.assert_array_equal(pm[k].numpy(),
                                          np.asarray(jm[k], np.float32))
        assert pm["y_scale"] == float(jm["y_scale"])
        np.testing.assert_array_equal(pm["resid_q"], jm["resid_q"])


@pytest.mark.parametrize("bad", ["kind", "missing", "chain", "last", "mu",
                                 "resid_q"])
def test_version_layout_is_checked(versions, bad):
    jm = versions[0][0]
    mo = {**jm, "params": dict(jm["params"])}
    if bad == "kind":
        mo["kind"] = "LSTM"
    elif bad == "missing":
        del mo["params"]["b4"]
    elif bad == "chain":
        mo["params"]["w2"] = mo["params"]["w2"][:-1]
    elif bad == "last":
        mo["params"]["w4"] = np.concatenate([mo["params"]["w4"]] * 2, axis=1)
        mo["params"]["b4"] = np.zeros(2)
    elif bad == "mu":
        mo["mu"] = mo["mu"][:-1]
    else:
        mo["resid_q"] = np.zeros(3)
    with pytest.raises(ValueError):
        ann_version_from_numpy(mo, "cpu")


def test_training_returns_scorable_device_versions(systems):
    """Training runs in the port: ``fleet_train`` and ``train()`` return
    model objects in the port's layout (f32 tensors on the system's
    device, ``resid_q`` float64), which the fleet path scores through
    ``fleet_mlp``."""
    _, tc = systems
    insts = _instances(tc, ANNForecaster)
    mos = ANNForecaster.fleet_train(insts) + [insts[0].train()]
    for mo in mos:
        assert mo["kind"] == "ANN"
        for t in (*mo["params"].values(), mo["mu"], mo["sd"]):
            assert t.dtype == torch.float32 and t.device == tc.device
            assert bool(torch.isfinite(t).all())
        assert mo["params"]["w1"].shape == (HP["hidden"], HP["hidden"])
        assert mo["resid_q"].dtype == np.float64
        assert mo["resid_q"][0] < 0 < mo["resid_q"][1]
    before = ops.invocation_count()
    got = ANNForecaster.fleet_score(insts + insts[:1], mos)
    assert ops.invocation_count() - before == 24
    for _, vals, lo, hi in got:
        assert np.isfinite(vals).all() and (lo < vals).all() \
            and (vals < hi).all()
