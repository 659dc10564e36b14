"""The port's training half against the JAX package's, for the paper's four
forecasters at the reference's test sizes (``tests/test_fleet_rollout.py``):
``fleet_train`` and single ``train()`` on the same site give the same
versions, forecasts and bands; a poll sequence that retrains on a WARM
runtime state (the device design assembly) matches the JAX package's;
versions cross both ways through the numpy converters.

The stochastic fits (ANN, LSTM) start from the JAX package's initial
weights: ``_init_fleet`` is swapped for one returning ``repro``'s
``_init`` values for the same keys (``split(PRNGKey(seed), n)`` for a
bin, ``PRNGKey(seed)`` for one instance), converted through the numpy
converters.

The closed-form fits (LR, GAM) are held against the JAX package run with
float64 enabled, which solves its ridge exactly, as the port does
(``repro_torch.forecast.linear._ridge_fit``): in f32 the normal equations
of GAM's ill-conditioned design carry noise that differs from library to
library, and on this site the JAX package's own fleet and single GAM
forecasts already differ by more than the forecast tolerance.

Tolerances: trained params at rtol 5e-2 / atol 5e-3 (the reference's
cross-reassociation contract, ``tests/test_fleet_mesh.py``), closed-form
theta at rtol 1e-3 / atol 3e-4 (LR's, ``tests/test_forecast.py``),
forecasts, bands and ``resid_q`` at rtol 2e-3 / atol 1e-3
(``repro.testing.FLEET_RTOL/ATOL``)."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.core import Castor as JaxCastor
from repro.core import Schedule as JaxSchedule
from repro.forecast import PAPER_MODELS as JAX_MODELS
from repro.forecast import ann as jax_ann
from repro.forecast import lstm as jax_lstm
from repro.testing import FLEET_ATOL, FLEET_RTOL
from repro.timeseries.ingest import SiteSpec as JaxSiteSpec
from repro.timeseries.ingest import build_site as jax_build_site
from repro_torch.core import Castor, Schedule
from repro_torch.forecast import (PAPER_MODELS, ann, ann_version_from_numpy,
                                  gam_version_from_numpy, lr_version_from_numpy,
                                  lstm, lstm_version_from_numpy,
                                  version_to_numpy)
from repro_torch.timeseries.ingest import SiteSpec, build_site
from repro_torch.timeseries.transforms import DAY, HOUR

torch.set_num_threads(1)

NOW = 40 * DAY
ENTS = ["R_PRO_0_0", "R_PRO_0_1", "R_PRO_0_2"]
MODELS = {
    "LR": {"target_lags": 12, "weather_lags": 4},
    "GAM": {"target_lags": 12, "weather_lags": 4},
    "ANN": {"hidden": 24, "epochs": 40, "target_lags": 12},
    "LSTM": {"hidden": 12, "epochs": 40, "target_lags": 12},
}
CONVERT = {"LR": lr_version_from_numpy, "GAM": gam_version_from_numpy,
           "ANN": ann_version_from_numpy, "LSTM": lstm_version_from_numpy}
PARAM_TOL = dict(rtol=5e-2, atol=5e-3)
THETA_TOL = dict(rtol=1e-3, atol=3e-4)
FC_TOL = dict(rtol=FLEET_RTOL, atol=FLEET_ATOL)
CLOSED_FORM = ("LR", "GAM")


def reference(kind):
    """The precision the JAX package runs ``kind`` in: float64 for the
    closed-form fits (its exact ridge), its default f32 otherwise."""
    return jax.enable_x64(kind in CLOSED_FORM)


def _jax_keys(seed, n, fleet):
    root = jax.random.PRNGKey(seed)
    return list(jax.random.split(root, n)) if fleet else [root]


def _stack(per):
    return {k: torch.stack([p[k] for p in per]) for k in per[0]
            if k != "y_scale"}


def _numpy_mo(kind, params, n_features):
    return {"kind": kind, "params": {**params, "y_scale": 1.0},
            "mu": np.zeros(n_features), "sd": np.ones(n_features),
            "y_scale": 1.0, "resid_q": np.zeros(2)}


@contextlib.contextmanager
def jax_initial_weights(fleet: bool):
    """Swap the port's ``_init_fleet`` of ANN and LSTM for the JAX
    package's initial weights: a bin's instances from the split keys, one
    instance (single ``train()``) from the root key."""
    def ann_init(seed, n, f_in, width, device):
        per = []
        for key in _jax_keys(seed, n, fleet):
            p = jax_ann._init(key, f_in, width)
            params = {f"w{i}": np.asarray(w) for i, w in enumerate(p["w"])}
            params.update({f"b{i}": np.asarray(b)
                           for i, b in enumerate(p["b"])})
            per.append(ann_version_from_numpy(
                _numpy_mo("ANN", params, f_in), device)["params"])
        return _stack(per)

    def lstm_init(seed, n, width, device):
        per = []
        for key in _jax_keys(seed, n, fleet):
            params = {k: np.asarray(v)
                      for k, v in jax_lstm._init(key, width).items()}
            per.append(lstm_version_from_numpy(
                _numpy_mo("LSTM", params, 1), device)["params"])
        return _stack(per)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ann, "_init_fleet", ann_init)
        mp.setattr(lstm, "_init_fleet", lstm_init)
        yield


def _site(castor, build, spec_cls):
    build(castor, spec_cls("R", n_prosumers=3, n_feeders=1,
                           n_substations=1, seed=5),
          t0=0.0, t1=NOW + 2 * DAY)
    return castor


@pytest.fixture(scope="module")
def systems():
    return (_site(JaxCastor(), jax_build_site, JaxSiteSpec),
            _site(Castor(device="cpu"), build_site, SiteSpec))


def _instances(c, cls, kind, ents=ENTS):
    up = {"train_window_days": 14, "now": NOW, **MODELS[kind]}
    return [cls(context=c.graph.context("ENERGY_LOAD", e), task="train",
                model_id=f"tr-{e}", model_version=None, user_params=up,
                system=c) for e in ents]


def assert_versions_close(got, want, kind):
    """A port model object against a JAX one: params at the trained-param
    tolerance (closed-form theta tighter), mu/sd at f32, y_scale, and the residual
    quantiles at the forecast tolerance."""
    g = version_to_numpy(got)
    assert g["kind"] == want["kind"] == kind
    assert set(g["params"]) == set(want["params"])
    for k, w in want["params"].items():
        tol = THETA_TOL if k == "theta" else PARAM_TOL
        if k == "cols":
            np.testing.assert_array_equal(g["params"][k], w)
        else:
            np.testing.assert_allclose(g["params"][k], np.asarray(w),
                                       err_msg=f"{kind} params[{k}]", **tol)
    for k in ("mu", "sd"):
        np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-6)
    assert g["y_scale"] == pytest.approx(want["y_scale"], rel=1e-6)
    np.testing.assert_allclose(g["resid_q"], want["resid_q"], **FC_TOL)


def assert_forecasts_close(got, want):
    for (gt, *g), (wt, *w) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gt, wt)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **FC_TOL)


@pytest.fixture(scope="module")
def fleet_trained(systems):
    """Both packages' ``fleet_train`` of every kind on the same bin."""
    jc, tc = systems
    out = {}
    with jax_initial_weights(fleet=True):
        for kind, cls in PAPER_MODELS.items():
            jcls = JAX_MODELS[kind]
            with reference(kind):
                want = jcls.fleet_train(_instances(jc, jcls, kind))
            out[kind] = (want, cls.fleet_train(_instances(tc, cls, kind)))
    return out


@pytest.mark.parametrize("kind", list(MODELS))
def test_fleet_train_matches_jax(fleet_trained, kind):
    want, got = fleet_trained[kind]
    assert len(got) == len(want) == len(ENTS)
    for g, w in zip(got, want):
        for t in (*g["params"].values(), g["mu"], g["sd"]):
            assert t.device.type == "cpu"
        assert g["mu"].dtype == torch.float32
        assert_versions_close(g, w, kind)


@pytest.mark.parametrize("kind", list(MODELS))
def test_fleet_forecasts_of_trained_versions_match_jax(systems,
                                                       fleet_trained, kind):
    jc, tc = systems
    want_mos, got_mos = fleet_trained[kind]
    jcls, cls = JAX_MODELS[kind], PAPER_MODELS[kind]
    with reference(kind):
        want = jcls.fleet_score(_instances(jc, jcls, kind), want_mos)
    got = cls.fleet_score(_instances(tc, cls, kind), got_mos)
    assert_forecasts_close(got, want)


@pytest.mark.parametrize("kind", list(MODELS))
def test_single_train_matches_jax(systems, kind):
    """One instance's ``train()`` (LocalPool's path: its own rng from the
    model id, the root key) and its ``score()``."""
    jc, tc = systems
    jcls, cls = JAX_MODELS[kind], PAPER_MODELS[kind]
    jinst = _instances(jc, jcls, kind, ENTS[:1])[0]
    tinst = _instances(tc, cls, kind, ENTS[:1])[0]
    with jax_initial_weights(fleet=False):
        with reference(kind):
            want = jinst.train()
            want_fc = jinst.score(want)
        got = tinst.train()
    assert_versions_close(got, want, kind)
    assert_forecasts_close([tinst.score(got)], [want_fc])


@pytest.mark.parametrize("kind", CLOSED_FORM)
def test_closed_form_fleet_equals_single(systems, kind):
    """The port's fleet and single closed-form fits give the same theta
    and forecasts (the LocalPool == Fleet contract) on this site, where
    the JAX package's own f32 fits do not."""
    _, tc = systems
    cls = PAPER_MODELS[kind]
    insts = _instances(tc, cls, kind)
    fleet = cls.fleet_train(insts)
    for inst, fm in zip(insts, fleet):
        sm = inst.train()
        torch.testing.assert_close(sm["params"]["theta"],
                                   fm["params"]["theta"], **THETA_TOL)
        assert_forecasts_close([inst.score(sm)], [inst.score(fm)])


@pytest.mark.parametrize("kind", CLOSED_FORM)
def test_local_tick_trains_like_fleet_tick(kind):
    """Through the executors: a LocalPool tick (``train()`` per job) and a
    fleet tick (``fleet_train`` per bin) persist the same versions and
    forecasts for the closed-form models (the stochastic ones draw their
    initial weights per bin by design)."""
    castors = {}
    for executor in ("fleet", "local"):
        c = _site(Castor(device="cpu"), build_site, SiteSpec)
        c.publish("m", "1.0", PAPER_MODELS[kind])
        c.deploy_for_all(package="m", signal="ENERGY_LOAD", name_prefix="e",
                         kind="PROSUMER", train=Schedule(NOW, 1e12),
                         score=Schedule(NOW, 1e12),
                         user_params={"train_window_days": 14,
                                      **MODELS[kind]})
        res = c.tick(NOW, executor=executor)
        assert len(res) == 6 and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
        castors[executor] = c
    for e in ENTS:
        fleet, local = (castors[x].versions.get(f"e-{e}").params
                        for x in ("fleet", "local"))
        torch.testing.assert_close(local["params"]["theta"],
                                   fleet["params"]["theta"], **THETA_TOL)
        (fa,), (fb,) = (castors[x].predictions.history(f"e-{e}")
                        for x in ("fleet", "local"))
        assert_forecasts_close([(fb.times, fb.values, fb.lower, fb.upper)],
                               [(fa.times, fa.values, fa.lower, fa.upper)])


@pytest.mark.parametrize("kind", list(MODELS))
def test_trained_versions_cross_both_ways(fleet_trained, kind):
    """``version_to_numpy`` and the kind's converter are inverses: the
    JAX package's versions convert in, the port's convert out and back."""
    want, got = fleet_trained[kind]
    for w, g in zip(want, got):
        back = CONVERT[kind](version_to_numpy(g), "cpu")
        for k, t in g["params"].items():
            assert back["params"][k].dtype == t.dtype
            torch.testing.assert_close(back["params"][k], t, rtol=0, atol=0)
        assert back["y_scale"] == g["y_scale"]
        np.testing.assert_array_equal(back["resid_q"], g["resid_q"])
        assert_versions_close(CONVERT[kind](w, "cpu"), w, kind)


BAD = ["kind", "missing", "shape", "mu", "resid_q"]


def _break(mo, kind, bad):
    mo = {**mo, "params": dict(mo["params"])}
    p = mo["params"]
    if bad == "kind":
        mo["kind"] = "ANN" if kind != "ANN" else "LR"
    elif bad == "missing":
        del p[sorted(k for k in p if k != "y_scale")[-1]]
    elif bad == "shape":
        name = {"LR": "theta", "GAM": "knots", "ANN": "w2",
                "LSTM": "wh1"}[kind]
        p[name] = np.asarray(p[name])[..., :-1]
    elif bad == "mu":
        mo["mu"] = np.asarray(mo["mu"])[:-1]
    else:
        mo["resid_q"] = np.zeros(3)
    return mo


@pytest.mark.parametrize("bad", BAD)
@pytest.mark.parametrize("kind", list(MODELS))
def test_version_layouts_are_checked(fleet_trained, kind, bad):
    mo = _break(fleet_trained[kind][0][0], kind, bad)
    with pytest.raises(ValueError):
        CONVERT[kind](mo, "cpu")


def test_version_to_numpy_rejects_other_layouts(fleet_trained):
    with pytest.raises(ValueError):
        version_to_numpy(fleet_trained["LR"][0][0])      # numpy, not port


# ---------------- a warm runtime retrains (device assembly) ----------------

POLLS = 3
STEADY = {"ANN": {"hidden": 8, "epochs": 20}, "LR": {}}


def _steady(castor, build, spec_cls, schedule_cls, cls, hp):
    """``repro.testing.build_steady_castor``'s fleet at n=3, retraining
    every hour, so polls 2..3 retrain on a warm runtime state."""
    fleet_now = 35 * DAY
    build(castor, spec_cls("Z", n_prosumers=3, n_feeders=1,
                           n_substations=1, seed=9),
          t0=0.0, t1=38 * DAY)
    castor.publish("m", "1.0", cls)
    castor.deploy_for_all(package="m", signal="ENERGY_LOAD",
                          name_prefix="s", kind="PROSUMER",
                          train=schedule_cls(fleet_now, HOUR),
                          score=schedule_cls(fleet_now, HOUR),
                          user_params={"train_window_days": 14, **hp})
    modes = []
    for k in range(POLLS):
        res = castor.tick(fleet_now + k * HOUR)
        assert res and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
        modes.append([(s["bin"], s["runtime"], s["delta_rows"])
                      for s in castor.fleet_executor().last_bin_stats])
    return castor, modes


@pytest.mark.parametrize("kind", list(STEADY))
def test_warm_runtime_retrain_matches_jax(kind):
    with jax_initial_weights(fleet=True):
        with reference(kind):
            jc, jmodes = _steady(JaxCastor(), jax_build_site, JaxSiteSpec,
                                 JaxSchedule, JAX_MODELS[kind], STEADY[kind])
        tc, tmodes = _steady(Castor(device="cpu"), build_site, SiteSpec,
                             Schedule, PAPER_MODELS[kind], STEADY[kind])
    # the same bins in the same runtime modes, warm from the second poll
    assert tmodes == jmodes
    assert [m for _, m, _ in tmodes[1]] == ["warm", "warm"]
    # and the warm train bins assembled on the device: no f64 host rows
    rt = tc.fleet_executor().runtime
    assert rt.warm_loads >= POLLS - 1
    assert all(s.targets_host is None for s in rt._states.values())
    for i in range(3):
        name = f"s-Z_PRO_0_{i}"
        want = jc.versions.history(name)
        got = tc.versions.history(name)
        assert [v.trained_at for v in got] == [v.trained_at for v in want]
        for g, w in zip(got, want):
            assert_versions_close(g.params, w.params, kind)
        for g, w in zip(tc.predictions.history(name),
                        jc.predictions.history(name), strict=True):
            assert g.created_at == w.created_at
            assert g.model_version == w.model_version
            for a, b in ((g.values, w.values), (g.lower, w.lower),
                         (g.upper, w.upper)):
                np.testing.assert_allclose(a, b, **FC_TOL)
    # every score bin ran on the train handoff of its own tick
    assert rt.handoffs == POLLS
