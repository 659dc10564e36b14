"""LR forecaster (paper Table 1): ridge regression on weather + lag +
calendar features. Closed-form fit (normal equations solved in float64,
theta kept in f32); the fleet path is one batched solve over the bin."""
from __future__ import annotations

import torch

from .base import ForecastModelBase, device_version, numpy_params, to_device


def _ridge_fit(X, y, lam: float = 1e-2):
    """Ridge on the augmented design ``[X, 1]``, batched over a leading
    instance axis: X (N, T, F), y (N, T) f32 tensors -> theta (N, F + 1)
    f32, one ``torch.linalg.solve`` for the whole bin. Shared by LR and
    GAM (single and fleet).

    The normal equations are formed and solved in float64 and theta is
    rounded to f32 once: GAM's expanded design is ill-conditioned, so an
    f32 solve carries noise in theta that differs from library to
    library, and it reaches the forecasts."""
    Xb = torch.cat([X, X.new_ones(X.shape[:-1] + (1,))], dim=-1).double()
    Xt = Xb.transpose(-1, -2)
    A = Xt @ Xb + lam * torch.eye(Xb.shape[-1], dtype=Xb.dtype,
                                  device=X.device)
    b = Xt @ y.double()[..., None]
    return torch.linalg.solve(A, b)[..., 0].float()


def _ridge_fleet(X, y, lam: float = 1e-2, mesh=None):
    """The batched ridge solve of a bin; with ``mesh`` (a fleet mesh) the
    instance axis is split over the mesh's devices, shard by shard
    (``distributed.sharding.fleet_sharded``). Shared by the LR and GAM
    fleet fits."""
    if mesh is None:
        return _ridge_fit(X, y, lam)
    from ..distributed.sharding import fleet_sharded
    return fleet_sharded(lambda xx, yy: _ridge_fit(xx, yy, lam), mesh)(X, y)


def lr_version_from_numpy(model_object: dict, device) -> dict:
    """Convert an LR version in the persisted numpy layout (``params``
    ``{"theta": (F + 1,)}``) into the port's model object, f32 on
    ``device``. Raises ``ValueError`` on any other layout."""
    p = numpy_params(model_object, LinearForecaster.KIND, ["theta"])
    if p["theta"].ndim != 1 or p["theta"].shape[0] < 2:
        raise ValueError(f"theta must be (F + 1,), got {p['theta'].shape}")
    return device_version(model_object, p, p["theta"].shape[0] - 1, device)


class LinearForecaster(ForecastModelBase):
    KIND = "LR"
    SUPPORTS_FLEET = True

    def _fit(self, X, y, rng):
        device = self.system.device
        theta = _ridge_fit(to_device(X, device)[None],
                           to_device(y, device)[None])[0]
        return {"theta": theta}

    def _predict(self, params, X):
        th = params["theta"]
        return (X @ th[:-1] + th[-1]).cpu().numpy()

    @classmethod
    def _fleet_fit(cls, X, y, rng, up, device, mesh=None):
        # stays device-resident: fleet_train hands the stacked theta to the
        # runtime for scoring
        return {"theta": _ridge_fleet(to_device(X, device),
                                      to_device(y, device), mesh=mesh)}

    @classmethod
    def _fleet_window_predict(cls, stacked, X):
        # (N, T, F) design against per-instance theta in one einsum, f64
        th = stacked["theta"].double()                  # (N, F+1)
        X = torch.as_tensor(X, dtype=torch.float64, device=th.device)
        out = torch.einsum("ntf,nf->nt", X, th[:, :-1]) + th[:, -1:]
        return out.cpu().numpy()

    @classmethod
    def _fleet_predict_traced(cls, stacked, x):
        th = stacked["theta"]
        return torch.einsum("nf,nf->n", x, th[:, :-1]) + th[:, -1]

    @classmethod
    def _device_predict_factory(cls, spec, statics):
        return cls._fleet_predict_traced
