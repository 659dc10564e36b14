"""Shared load/transform/train/score plumbing for the paper's four
forecasters.

Each concrete model supplies:
    _fit(X, y, rng) -> params               (one instance, standardized X)
    _predict(params, X) -> yhat             (one-step prediction, plain torch)
and optionally the fleet hooks (stacked across instances):
    _fleet_fit(X, y, rng, up, device) -> stacked params (leading N)
    _fleet_window_predict(stacked, X) -> (N, T) float64 one-step predictions

A model object here is ``{"kind", "params": {name: tensor}, "mu", "sd"
(f32 tensors (F,)), "y_scale" (float), "resid_q" (numpy f64 (2,))}`` with
every tensor on the system's device, so scoring never re-uploads a
version. Versions in the persisted numpy layout cross through the
``*_version_from_numpy`` converters and back through
``version_to_numpy``.

user_params (Listing 2): train_window_days, horizon, frequency, target_lags,
weather_lags, plus model-specific extras (hidden, epochs, lr, ...).
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.registry import ModelInterface
from ..obs.trace import get_tracer
from ..timeseries.transforms import DAY, calendar_phases
from .features import (FeatureSpec, bucket_n, design_matrix, edge_pad,
                       fleet_hourly_series, make_device_rollout,
                       recursive_forecast)


class _LRUCache:
    """Bounded LRU for built rollouts, with hit/miss counters (surfaced per
    bin via ``FleetExecutor.last_bin_stats``)."""

    def __init__(self, cap: int = 32):
        self.cap = int(cap)
        self._d: "OrderedDict[tuple, Callable]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        fn = self._d.get(key)
        if fn is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return fn

    def put(self, key, fn):
        self._d[key] = fn
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)
        return fn

    def __len__(self):
        return len(self._d)

    def stats(self) -> dict:
        return {"size": len(self._d), "cap": self.cap,
                "hits": self.hits, "misses": self.misses}


#: whole-horizon rollouts, keyed by (model class, FeatureSpec, horizon,
#: class-specific statics) — one per configuration, reused across every
#: score bin of that configuration. LRU-bounded (see _LRUCache).
_ROLLOUT_CACHE = _LRUCache(cap=32)


def rollout_cache_stats() -> dict:
    return _ROLLOUT_CACHE.stats()


#: prediction-interval quantiles (lower, upper) for every forecaster's
#: residual band — q10..q90, the band the detection flow compares against
BAND_QUANTILES = (0.1, 0.9)


def prediction_bands(model_object, values):
    """(lower, upper) quantile bands around a rolled-out point forecast.

    Bands come from the TRAINING residual quantiles persisted in the model
    object (``resid_q``, one-step-ahead errors), widened by sqrt(h+1) per
    horizon step — the standard recursive-forecast error growth heuristic:
    step 0 is the raw one-step band, later steps widen as accumulated
    prediction error compounds. Works per instance (``resid_q`` shape
    ``(2,)``, values ``(H,)``) and per fleet bin (``(N, 2)`` / ``(N, H)``).
    Returns ``(None, None)`` for model objects without residual quantiles
    — callers persist band-less forecasts rather than failing.
    """
    rq = model_object.get("resid_q") if isinstance(model_object, dict) \
        else None
    if rq is None:
        return None, None
    values = np.asarray(values, np.float64)
    rq = np.asarray(rq, np.float64)
    widen = np.sqrt(1.0 + np.arange(values.shape[-1], dtype=np.float64))
    return (values + rq[..., 0, None] * widen,
            values + rq[..., 1, None] * widen)


def stack_versions(model_objects):
    """Fleet layout of per-instance model objects: ``(params, mu, sd)``
    with a leading instance axis, stacked on the objects' device."""
    stacked = {k: torch.stack([m["params"][k] for m in model_objects])
               for k in model_objects[0]["params"]}
    mu = torch.stack([m["mu"] for m in model_objects])
    sd = torch.stack([m["sd"] for m in model_objects])
    return stacked, mu, sd


def to_device(a, device) -> torch.Tensor:
    """``a`` (numpy array or tensor) as an f32 tensor on ``device``."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def to_host(a) -> np.ndarray:
    """``a`` (numpy array or tensor) as a numpy array of its dtype."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def fit_adam(params: Dict[str, torch.Tensor], loss_fn, epochs: int,
             lr: float) -> Dict[str, torch.Tensor]:
    """Full-batch Adam from ``params`` for ``epochs`` steps on
    ``loss_fn(params)``, in the JAX package's arithmetic (β 0.9 / 0.999,
    ε 1e-8, bias-corrected, the step count in f32 from 1):

        m = 0.9 m + 0.1 g;  v = 0.999 v + 0.001 g²
        p = p − lr · (m / (1 − 0.9^t)) / (√(v / (1 − 0.999^t)) + 1e-8)

    Written as tensor ops rather than ``torch.optim.Adam``, whose
    rounding order differs. Stacked params with a loss that sums
    per-instance means give each instance its own Adam path. Products
    stay f32 (PyTorch leaves TF32 off for matmuls by default)."""
    names = list(params)
    ps = [params[k].detach().clone().requires_grad_(True) for k in names]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    one, b1, b2 = np.float32(1.0), np.float32(0.9), np.float32(0.999)
    for i in range(epochs):
        grads = torch.autograd.grad(loss_fn(dict(zip(names, ps))), ps)
        t = np.float32(i + 1)
        bc1, bc2 = float(one - b1 ** t), float(one - b2 ** t)
        with torch.no_grad():
            for p, m, v, g in zip(ps, ms, vs, grads):
                m.mul_(0.9).add_(g * 0.1)
                v.mul_(0.999).add_((g * 0.001).mul_(g))
                denom = (v / bc2).sqrt_().add_(1e-8)
                p.sub_((m / bc1).mul_(lr).div_(denom))
    return {k: p.detach() for k, p in zip(names, ps)}


def numpy_params(model_object: dict, kind: str,
                 names) -> Dict[str, np.ndarray]:
    """The params of a version of ``kind`` in the persisted numpy layout,
    as numpy arrays. Raises ``ValueError`` on another kind or other
    parameter names."""
    if model_object.get("kind") != kind:
        raise ValueError(f"not a {kind} version: "
                         f"kind={model_object.get('kind')!r}")
    p = model_object["params"]
    if set(p) != set(names):
        raise ValueError(f"{kind} params must be {sorted(names)}, "
                         f"got {sorted(p)}")
    return {k: np.asarray(v) for k, v in p.items()}


def device_version(model_object: dict, params: Dict[str, np.ndarray],
                   n_features: int, device) -> dict:
    """The port's model object for a persisted-layout version whose
    ``params`` the caller has checked: floating arrays become f32 tensors
    and integer arrays int64 tensors on ``device``. Raises ``ValueError``
    when ``mu``/``sd`` are not ``(n_features,)`` or ``resid_q`` is not
    ``(2,)``."""
    mu, sd = np.asarray(model_object["mu"]), np.asarray(model_object["sd"])
    if mu.shape != (n_features,) or sd.shape != (n_features,):
        raise ValueError(f"mu {mu.shape} / sd {sd.shape} must be "
                         f"({n_features},)")
    resid_q = np.asarray(model_object["resid_q"], np.float64)
    if resid_q.shape != (2,):
        raise ValueError(f"resid_q must be (2,), got {resid_q.shape}")

    def dev(a):
        a = np.asarray(a)
        a = a.astype(np.int64 if a.dtype.kind in "iu" else np.float32)
        return torch.tensor(a, device=device)

    return {"kind": model_object["kind"],
            "params": {k: dev(v) for k, v in params.items()},
            "mu": dev(mu), "sd": dev(sd),
            "y_scale": float(model_object["y_scale"]), "resid_q": resid_q}


def version_to_numpy(model_object: dict) -> dict:
    """The persisted numpy layout of a port model object, the inverse of
    the ``*_version_from_numpy`` converters: every tensor becomes a numpy
    array of its dtype, a 0-d ``params["y_scale"]`` a float. Raises
    ``ValueError`` on anything else."""
    p = model_object.get("params") if isinstance(model_object, dict) \
        else None
    if not isinstance(p, dict) or not all(
            torch.is_tensor(v) for v in (*p.values(), model_object.get("mu"),
                                          model_object.get("sd"))):
        raise ValueError("not a port model object: params, mu and sd must "
                         "be tensors")
    resid_q = np.asarray(model_object.get("resid_q"), np.float64)
    if resid_q.shape != (2,):
        raise ValueError(f"resid_q must be (2,), got {resid_q.shape}")
    params = {k: v.detach().cpu().numpy() for k, v in p.items()}
    if "y_scale" in params and params["y_scale"].ndim == 0:
        params["y_scale"] = float(params["y_scale"])
    return {"kind": model_object["kind"], "params": params,
            "mu": model_object["mu"].cpu().numpy(),
            "sd": model_object["sd"].cpu().numpy(),
            "y_scale": float(model_object["y_scale"]), "resid_q": resid_q}


class ForecastModelBase(ModelInterface):
    DEFAULTS = {"train_window_days": 28, "horizon": 24}
    #: the fleet hooks accept a ``runtime=`` kwarg (FleetRuntime): the
    #: executor only threads its runtime through classes advertising this
    SUPPORTS_RUNTIME = True

    # ------------- paper 4-function workflow -------------
    def load(self):
        """Single-instance case of ``fleet_load``: one shared pipeline is
        what makes LocalPool and Fleet execution structurally equivalent."""
        self.fleet_load([self])
        return self._loaded

    def transform(self):
        spec, times, target, temps, now = self._loaded
        X, y = design_matrix(spec, times, target, temps)
        mu, sd = X.mean(0), X.std(0) + 1e-8
        self._xy = ((X - mu) / sd, y, mu, sd)
        return self._xy

    def train(self) -> dict:
        self.load()
        X, y, mu, sd = self.transform()
        # stable across processes (hash() is salted)
        rng = np.random.default_rng(zlib.crc32(self.model_id.encode()))
        device = self.system.device
        params = self._fit(X, y, rng)
        # one-step residuals over the training window feed the q10/q90
        # prediction band persisted with every forecast (X is standardized)
        yhat = self._predict(params, to_device(X, device))
        resid = y - np.asarray(yhat, np.float64)
        return {"kind": self.KIND, "params": params,
                "mu": to_device(mu, device), "sd": to_device(sd, device),
                "y_scale": float(np.abs(y).max() + 1e-6),
                "resid_q": np.quantile(resid, BAND_QUANTILES)}

    def score(self, model_object):
        self.load()
        spec, times, target, temps, now = self._loaded
        up = {**self.DEFAULTS, **self.user_params}
        H = int(up["horizon"])
        warm = max(spec.target_lags, spec.weather_lags) + 1
        ent = self.context.entity
        # history grid ends at now-step; the first unknown interval is AT now
        fut_t = now + spec.step * np.arange(0, H)
        temps_future = self.system.weather.forecast(ent.lat, ent.lon, now, fut_t)
        mu, sd = model_object["mu"], model_object["sd"]
        device = self.system.device

        def predict(x):
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            return self._predict(model_object["params"], (x - mu) / sd)

        vals = recursive_forecast(predict, spec, target[-warm:], temps[-warm:],
                                  temps_future, now, H)
        lower, upper = prediction_bands(model_object, vals)
        return fut_t, vals, lower, upper

    # ------------- fleet plumbing (stacked across instances) -------------
    @classmethod
    def fleet_load(cls, instances: List[ModelInterface]) -> None:
        """Batched ``load()`` for a fleet bin: ONE ``store.read_many`` per
        shared (window, step) group instead of one ``read()`` per instance.

        Jobs in a bin share user_params and ``now``, so normally this is a
        single group — the whole bin's history arrives in one store call.
        Sets each instance's ``_loaded`` to exactly what ``load()`` would,
        keeping LocalPool and Fleet observationally equivalent.
        """
        groups: dict = {}
        for inst in instances:
            up = {**cls.DEFAULTS, **inst.user_params}
            spec = FeatureSpec.from_params(up)
            now = float(up.get("now", 0.0))
            t0 = now - float(up["train_window_days"]) * DAY
            groups.setdefault((t0, now, spec.step), []).append(
                (inst, spec, now))
        for (t0, t1, step), members in groups.items():
            ctxs = [m[0].context for m in members]
            system = members[0][0].system
            grid, targets = fleet_hourly_series(system, ctxs, t0, t1, step)
            # ONE vectorized weather call per bin group; history weather is
            # the OBSERVED temperature (paper §4.2 trains on observed
            # weather), only the scoring horizon uses forecasts
            widx = [i for i, m in enumerate(members) if m[1].use_weather]
            if widx:
                ents = [members[i][0].context.entity for i in widx]
                wtemps = system.weather.temperature_many(
                    [e.lat for e in ents], [e.lon for e in ents], grid)
            temps_rows: Dict[int, np.ndarray] = {
                i: wtemps[j] for j, i in enumerate(widx)}
            for i, ((inst, spec, now), target) in enumerate(
                    zip(members, targets)):
                temps = temps_rows.get(i)
                if temps is None:
                    temps = np.zeros_like(grid)
                inst._loaded = (spec, grid, target, temps, now)

    @classmethod
    def _require_one_window(cls, instances) -> None:
        """Batched *scoring* rolls one recursive forecast with a single
        shared time axis, so a bin mixing execution times ('now') would
        silently compute wrong calendar features for all but the first
        instance — fail loudly instead."""
        nows = {inst._loaded[4] for inst in instances}
        if len(nows) > 1:
            raise RuntimeError(
                f"fleet bin mixes execution times {sorted(nows)[:3]}...; "
                "run each poll's jobs separately")

    @classmethod
    def _fleet_xy(cls, instances) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        cls.fleet_load(instances)
        Xs, ys, mus, sds = [], [], [], []
        for inst in instances:
            X, y, mu, sd = inst.transform()
            Xs.append(X), ys.append(y), mus.append(mu), sds.append(sd)
        return (np.stack(Xs), np.stack(ys), np.stack(mus), np.stack(sds))

    @classmethod
    def fleet_train(cls, instances: List[ModelInterface], *, mesh=None,
                    runtime=None):
        """Train a bin: one stacked fit on the system's device. The
        design comes from the runtime (a cold build answers with the host
        f64 design, a warm state assembles on the device) or, without
        one, from ``_fleet_xy``. Returns one model object per instance;
        their params are rows of the stacked device tensors, which the
        runtime keeps as the train->score handoff."""
        if mesh is not None:
            raise NotImplementedError("sharding a bin across cards is not "
                                      "ported; the executor passes mesh=None")
        state = loaded = None
        if runtime is not None:
            loaded = runtime.fleet_xy(cls, instances)
        if loaded is None:               # cold / runtime opted out
            X, y, mu, sd = cls._fleet_xy(instances)
        else:                            # device-resident incremental path
            X, y, mu, sd, state = loaded
        rng = np.random.default_rng(12345)
        # jobs in a bin share user_params_key, so the first instance's
        # merged params speak for the whole bin
        up = {**cls.DEFAULTS, **instances[0].user_params}
        device = instances[0].system.device
        params = cls._fleet_fit(X, y, rng, up, device)    # stacked, on device
        y_h = to_host(y)
        ymax = np.abs(y_h).max(axis=1)
        yhat = cls._fleet_window_predict(params, X)
        resid = y_h.astype(np.float64) - yhat
        rq = np.quantile(resid, BAND_QUANTILES, axis=1).T      # (N, 2)
        mu, sd = to_device(mu, device), to_device(sd, device)
        out = [{"kind": cls.KIND,
                "params": {k: v[i] for k, v in params.items()},
                "mu": mu[i], "sd": sd[i], "y_scale": float(ymax[i] + 1e-6),
                "resid_q": rq[i]} for i in range(len(instances))]
        if state is not None:
            runtime.note_trained(state, params, mu, sd, out)
        return out

    @classmethod
    def _fleet_predict(cls, stacked, X) -> np.ndarray:
        """One step of the host rollout (``rollout="host"``): the device
        predictor's values for X (N, F), on the host."""
        return cls._fleet_predict_traced(stacked, X).cpu().numpy()

    @classmethod
    def _fleet_window_predict(cls, stacked, X) -> np.ndarray:
        """One-step predictions over each instance's full standardized
        training design: ``X (N, T, F) -> (N, T)`` float64. Feeds the
        per-instance training-residual quantiles behind prediction bands.
        The default loops instances through ``_predict`` (none of the
        built-in predictors touch ``self``); each forecaster overrides
        with a batched path."""
        X = to_device(X, next(iter(stacked.values())).device)
        return np.stack([
            np.asarray(cls._predict(cls, {k: v[i] for k, v in
                                          stacked.items()}, X[i]),
                       np.float64) for i in range(X.shape[0])])

    @classmethod
    def _attach_bands(cls, model_objects, results):
        """Zip per-instance quantile bands onto ``(times, values)`` fleet
        results — shared by the device-runtime and cold scoring paths so
        both return the same 4-tuple shape."""
        return [(t, v, *prediction_bands(m, v))
                for m, (t, v) in zip(model_objects, results)]

    @classmethod
    def fleet_score(cls, instances: List[ModelInterface], model_objects, *,
                    mesh=None, runtime=None):
        if mesh is not None:
            raise NotImplementedError("sharding a bin across cards is not "
                                      "ported; the executor passes mesh=None")
        if runtime is not None:
            res = runtime.fleet_score(cls, instances, model_objects)
            if res is not None:
                return cls._attach_bands(model_objects, res)
        cls.fleet_load(instances)
        cls._require_one_window(instances)
        # jobs in a bin share user_params_key: one merge speaks for all
        up = {**cls.DEFAULTS, **instances[0].user_params}
        H = int(up["horizon"])
        spec = None
        y_hists, temp_hists, fut_ts = [], [], []
        for inst in instances:
            spec, times, target, temps, now = inst._loaded
            warm = max(spec.target_lags, spec.weather_lags) + 1
            fut_t = now + spec.step * np.arange(0, H)
            y_hists.append(target[-warm:])
            temp_hists.append(temps[-warm:])
            fut_ts.append(fut_t)
        # one vectorized weather call per bin (bitwise == per-instance)
        ents = [inst.context.entity for inst in instances]
        temps_futs = instances[0].system.weather.forecast_many(
            [e.lat for e in ents], [e.lon for e in ents],
            instances[0]._loaded[4], fut_ts[0])
        device = instances[0].system.device
        stacked, mu, sd = stack_versions(model_objects)
        t_start = fut_ts[0][0]
        y_hist = np.stack(y_hists)
        temp_hist = np.stack(temp_hists)
        temps_fut = np.stack(temps_futs)

        vals = None
        if up.get("rollout", "device") != "host":
            vals = cls._device_rollout(spec, up, stacked, mu, sd, y_hist,
                                       temp_hist, temps_fut, t_start, H,
                                       device)
        if vals is None:                 # reference path / no device hook
            def predict(x):                              # x: (N, F)
                x = torch.as_tensor(x, dtype=torch.float32, device=device)
                return cls._fleet_predict(stacked, (x - mu) / sd)

            vals = recursive_forecast(predict, spec, y_hist, temp_hist,
                                      temps_fut, t_start, H)
        return cls._attach_bands(
            model_objects, [(fut_ts[i], vals[i]) for i in range(len(instances))])

    # ------------- device-resident scoring rollout -------------
    @classmethod
    def _rollout_statics(cls, up: dict, stacked: dict) -> tuple:
        """Hashable per-class statics derived from the bin's shared
        user_params / stacked model params. Part of the rollout cache
        key."""
        return ()

    @classmethod
    def _device_predict_factory(cls, spec: FeatureSpec,
                                statics: tuple) -> Optional[Callable]:
        """Return a ``(stacked_params, x) -> (N,)`` one-step predictor on
        device tensors, or None to keep scoring on the numpy reference
        path (``recursive_forecast``)."""
        return None

    @classmethod
    def _device_rollout(cls, spec: FeatureSpec, up: dict, stacked, mu, sd,
                        y_hist, temp_hist, temps_future, t_start: float,
                        H: int, device) -> Optional[np.ndarray]:
        """Score a whole bin on ``device`` with one host round-trip (see
        ``make_device_rollout``) instead of H host-loop steps. Returns None
        when the model has no device predictor — callers then fall back to
        the numpy reference path, preserving the executor equivalence
        contract for models that cannot run device-resident."""
        statics = cls._rollout_statics(up, stacked)
        key = (cls, spec, H, statics)
        fn = _ROLLOUT_CACHE.get(key)
        if fn is None:
            predict = cls._device_predict_factory(spec, statics)
            if predict is None:
                return None
            fn = _ROLLOUT_CACHE.put(key, make_device_rollout(predict, spec, H))
        tl, wl = spec.target_lags, spec.weather_lags
        f32 = torch.float32
        y0 = torch.as_tensor(y_hist, dtype=f32, device=device)[..., -tl:]
        if spec.use_weather:
            tw0 = torch.as_tensor(temp_hist, dtype=f32,
                                  device=device)[..., -(wl + 1):]
        else:                            # unused window, keep it minimal
            tw0 = y0.new_zeros(y0.shape[:-1] + (1,))
        hod, dow = calendar_phases(t_start + spec.step * np.arange(H))
        # pad the instance axis to its bucket (per-instance recursion =>
        # padded lanes cannot perturb real ones); slice the pad back off
        n = y0.shape[0]
        pad = bucket_n(n) - n
        stacked = {k: edge_pad(v, pad) for k, v in stacked.items()}
        args = [edge_pad(torch.as_tensor(a, dtype=f32, device=device), pad)
                for a in (mu, sd, y0, tw0, temps_future)]
        # the span ends after the copy to the host, which waits for the
        # device: it is the rollout's wall time, launches included
        with get_tracer().span("rollout.device", n=n, horizon=H):
            out = fn(stacked, *args,
                     torch.as_tensor(hod, dtype=f32, device=device),
                     torch.as_tensor(dow, dtype=f32, device=device))
            return out[:n].cpu().numpy().astype(np.float64)
