"""GAM forecaster (paper Table 1): additive smooth terms via cubic B-spline
basis expansion on the continuous predictors (temperature, recent lags) +
linear terms, fitted by ridge — the classic penalised-basis GAM
approximation. The expansion of the training design runs on the host
(numpy, float64); the fleet fit is one batched solve over the expanded
designs, and the device rollout expands with ``_bspline_basis_torch``."""
from __future__ import annotations

import numpy as np
import torch

from .base import (ForecastModelBase, device_version, numpy_params, to_device,
                   to_host)
from .linear import _ridge_fit, _ridge_fleet

N_KNOTS = 8


def _spline_cols(up: dict) -> list:
    """Columns to spline-expand: the smooth predictors — concurrent
    temperature (sits right after the target lags in the design matrix)
    and the top target lag. Remaining features stay linear."""
    tl = int(up.get("target_lags", 24))
    cols = [0]                               # lag-1 (smooth autoregression)
    if up.get("use_weather", True):
        cols.append(tl)                      # concurrent temp
    return cols


def _bspline_basis(x, knots):
    """Cubic B-spline basis (numpy, де Boor via cox-de-boor on fixed grid).
    x: (..., ), knots: (K,) augmented internally. Returns (..., K+2)."""
    t = np.concatenate([[knots[0]] * 3, knots, [knots[-1]] * 3])
    n_basis = len(t) - 4
    x = np.clip(x, knots[0], knots[-1])
    B = np.zeros(x.shape + (len(t) - 1,))
    for i in range(len(t) - 1):
        B[..., i] = np.where((x >= t[i]) & (x < t[i + 1]), 1.0, 0.0)
    B[..., np.searchsorted(t, knots[-1]) - 1] = np.where(x >= knots[-1], 1.0,
                                                         B[..., np.searchsorted(t, knots[-1]) - 1])
    for k in range(1, 4):
        Bn = np.zeros(x.shape + (len(t) - 1 - k,))
        for i in range(len(t) - 1 - k):
            d1 = t[i + k] - t[i]
            d2 = t[i + k + 1] - t[i + 1]
            a = (x - t[i]) / d1 * B[..., i] if d1 > 0 else 0.0
            b = (t[i + k + 1] - x) / d2 * B[..., i + 1] if d2 > 0 else 0.0
            Bn[..., i] = a + b
        B = Bn
    return B[..., :n_basis]


def _expand(X, knot_sets, cols):
    """Spline-expand the given columns; keep every column linear as well
    (spline terms are additive corrections on top of the linear model)."""
    parts = [X]
    for knots, j in zip(knot_sets, cols):
        parts.append(_bspline_basis(X[..., j], knots))
    return np.concatenate(parts, axis=-1)


def _bspline_basis_torch(x, knots):
    """Torch twin of ``_bspline_basis``, batched per instance, for the
    device scoring rollout. x: (N,), knots: (N, K) each row strictly
    increasing. Returns (N, K+2)."""
    K = knots.shape[-1]
    t = torch.cat([knots[..., :1].expand(*knots.shape[:-1], 3), knots,
                   knots[..., -1:].expand(*knots.shape[:-1], 3)], dim=-1)
    x = torch.clamp(x, knots[..., 0], knots[..., -1])
    B = ((x[..., None] >= t[..., :-1])
         & (x[..., None] < t[..., 1:])).to(torch.float32)
    # right-closed last interval (x == last knot falls in the top basis)
    B[..., K + 1] = torch.where(x >= knots[..., -1], 1.0, B[..., K + 1])
    for k in range(1, 4):
        d1 = t[..., k:-1] - t[..., :-1 - k]
        d2 = t[..., k + 1:] - t[..., 1:-k]
        a = torch.where(d1 > 0, (x[..., None] - t[..., :-1 - k])
                        / torch.where(d1 > 0, d1, 1.0) * B[..., :-1], 0.0)
        b = torch.where(d2 > 0, (t[..., k + 1:] - x[..., None])
                        / torch.where(d2 > 0, d2, 1.0) * B[..., 1:], 0.0)
        B = a + b
    return B[..., :K + 2]


def _host_predict(X, theta, knots, cols):
    """One instance on the host, float64: X (..., F) numpy, the rest
    tensors of its version."""
    Xe = _expand(np.asarray(X, np.float64), list(knots.cpu().numpy()),
                 cols.tolist())
    th = theta.cpu().numpy()
    return Xe @ th[:-1] + th[-1]


def gam_version_from_numpy(model_object: dict, device) -> dict:
    """Convert a GAM version in the persisted numpy layout (``params``
    ``{"theta": (Fe + 1,), "knots": (C, K), "cols": (C,)}``, Fe = F +
    C (K + 2)) into the port's model object: theta and knots f32, cols
    int64 on ``device``. Raises ``ValueError`` on any other layout."""
    p = numpy_params(model_object, GAMForecaster.KIND,
                     ["theta", "knots", "cols"])
    th, knots, cols = p["theta"], p["knots"], p["cols"]
    if cols.ndim != 1 or cols.dtype.kind not in "iu" or knots.ndim != 2 \
            or knots.shape[0] != cols.shape[0] or th.ndim != 1:
        raise ValueError(f"knots {knots.shape} / cols {cols.shape} "
                         f"{cols.dtype} / theta {th.shape} do not match")
    n_features = th.shape[0] - 1 - cols.shape[0] * (knots.shape[1] + 2)
    if n_features < 1 or cols.min() < 0 or cols.max() >= n_features:
        raise ValueError(f"theta {th.shape} leaves {n_features} linear "
                         f"features for spline columns {cols.tolist()}")
    return device_version(model_object, p, n_features, device)


class GAMForecaster(ForecastModelBase):
    KIND = "GAM"
    SUPPORTS_FLEET = True

    def _cols(self):
        return _spline_cols({**self.DEFAULTS, **self.user_params})

    def _fit(self, X, y, rng):
        device = self.system.device
        cols = self._cols()
        knot_sets = [np.linspace(X[:, j].min() - 1e-3, X[:, j].max() + 1e-3,
                                 N_KNOTS) for j in cols]
        Xe = _expand(X, knot_sets, cols)
        theta = _ridge_fit(to_device(Xe, device)[None],
                           to_device(y, device)[None])[0]
        return {"theta": theta,
                "knots": to_device(np.stack(knot_sets), device),
                "cols": torch.tensor(cols, device=device)}

    def _predict(self, params, X):
        return _host_predict(X.cpu().numpy(), params["theta"],
                             params["knots"], params["cols"])

    @classmethod
    def _fleet_fit(cls, X, y, rng, up, device, mesh=None):
        # spline columns from the bin's SHARED user_params — a non-default
        # target_lags shifts the concurrent-temp column, so defaults here
        # would spline the wrong feature and diverge from LocalPool
        cols = _spline_cols(up)
        # spline expansion is host-side
        X = to_host(X)
        knots, Xes = [], []
        for i in range(X.shape[0]):
            ks = [np.linspace(X[i, :, j].min() - 1e-3, X[i, :, j].max() + 1e-3,
                              N_KNOTS) for j in cols]
            knots.append(np.stack(ks))
            Xes.append(_expand(X[i], ks, cols))
        th = _ridge_fleet(to_device(np.stack(Xes), device),
                          to_device(y, device), mesh=mesh)
        return {"theta": th, "knots": to_device(np.stack(knots), device),
                "cols": torch.tensor(cols, device=device).expand(
                    X.shape[0], len(cols)).contiguous()}

    @classmethod
    def _fleet_window_predict(cls, stacked, X):
        # knots differ per instance -> loop the expansion on the host; X is
        # (N, T, F) here and (N, F) in the host rollout, which shares it
        X = to_host(X)
        return np.stack([
            _host_predict(X[i], stacked["theta"][i], stacked["knots"][i],
                          stacked["cols"][i]) for i in range(X.shape[0])])

    _fleet_predict = _fleet_window_predict

    @classmethod
    def _rollout_statics(cls, up, stacked):
        # the columns the model was FITTED with (shared across the bin),
        # part of the rollout cache key
        return tuple(int(c) for c in stacked["cols"][0].tolist())

    @classmethod
    def _device_predict_factory(cls, spec, statics):
        cols = statics

        def predict(stacked, x):
            th, knots = stacked["theta"], stacked["knots"]
            parts = [x]
            for i, j in enumerate(cols):
                parts.append(_bspline_basis_torch(x[..., j], knots[:, i]))
            Xe = torch.cat(parts, dim=-1)
            return torch.einsum("nf,nf->n", Xe, th[:, :-1]) + th[:, -1]

        return predict
