"""LSTM forecaster (paper §4.2): 2 stacked LSTM layers over the last 24
hourly target values, sigmoid-scaled output, Adam(1e-3). Paper hidden 512;
``hidden`` user param keeps CPU runs fast. Fleet = one stacked fit with
per-instance Adam (``base.fit_adam``).

The cell is written out: gates i, f, g, o with the forget gate's +1 and
ONE bias per layer, as in the JAX package — ``torch.nn.LSTM`` has no +1
and trains two biases, so Adam would take another path."""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import (ForecastModelBase, device_version, fit_adam, numpy_params,
                   to_device, to_host)

N_LAYERS = 2
PARAM_NAMES = ([f"{w}{l}" for l in range(N_LAYERS) for w in ("wx", "wh", "b")]
               + ["wo", "bo"])


def _init_fleet(seed: int, n: int, width: int, device) -> dict:
    """Initial weights of ``n`` instances, stacked, f32, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``: ``wx{l}``
    ``(n, in_dim, 4W)`` and ``wh{l}`` ``(n, W, 4W)`` normal scaled by
    √(1/in_dim) and √(1/W), zero ``b{l}`` ``(n, 4W)``, ``wo`` ``(n, W, 1)``
    scaled by √(1/W), zero ``bo`` ``(n, 1)`` (the JAX package's law; tests
    substitute its values)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(*shape, fan):
        return torch.randn((n, *shape), generator=g, device=device) \
            * math.sqrt(1.0 / max(fan, 1))

    params, in_dim = {}, 1
    for l in range(N_LAYERS):
        params[f"wx{l}"] = normal(in_dim, 4 * width, fan=in_dim)
        params[f"wh{l}"] = normal(width, 4 * width, fan=width)
        params[f"b{l}"] = torch.zeros((n, 4 * width), device=device)
        in_dim = width
    params["wo"] = normal(width, 1, fan=width)
    params["bo"] = torch.zeros((n, 1), device=device)
    return params


def _fleet_lstm_out(stacked, seqs, y_scale):
    """Stacked forward: seqs (N, B, T) normalised target windows in time
    order -> (N, B) predictions in physical units."""
    n, b, T = seqs.shape
    xs = seqs[..., None]                                  # (N, B, T, 1)
    for l in range(N_LAYERS):
        wx, wh, bias = stacked[f"wx{l}"], stacked[f"wh{l}"], stacked[f"b{l}"]
        W = wh.shape[1]
        # every step's input product at once, then the recurrence
        zx = torch.bmm(xs.reshape(n, b * T, -1), wx).reshape(n, b, T, 4 * W)
        h = c = seqs.new_zeros((n, b, W))
        hs = []
        for t in range(T):
            z = zx[:, :, t] + torch.bmm(h, wh) + bias[:, None, :]
            i, f, g, o = z.split(W, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        xs = torch.stack(hs, dim=2)                       # (N, B, T, W)
    raw = (torch.bmm(xs[:, :, -1], stacked["wo"])
           + stacked["bo"][:, None, :])[..., 0]
    return torch.sigmoid(raw) * y_scale[:, None]


def lstm_version_from_numpy(model_object: dict, device) -> dict:
    """Convert an LSTM version in the persisted numpy layout (``params``
    ``{wx0, wh0, b0, wx1, wh1, b1, wo, bo, y_scale}``) into the port's
    model object, f32 on ``device``. Raises ``ValueError`` on any other
    layout or on shapes that do not chain."""
    p = numpy_params(model_object, LSTMForecaster.KIND,
                     PARAM_NAMES + ["y_scale"])
    W = p["wh0"].shape[0] if p["wh0"].ndim == 2 else -1
    in_dim = 1
    for l in range(N_LAYERS):
        shapes = (p[f"wx{l}"].shape, p[f"wh{l}"].shape, p[f"b{l}"].shape)
        if shapes != ((in_dim, 4 * W), (W, 4 * W), (4 * W,)):
            raise ValueError(f"layer {l}: wx/wh/b {shapes} do not chain "
                             f"from input {in_dim} at width {W}")
        in_dim = W
    if p["wo"].shape != (W, 1) or p["bo"].shape != (1,):
        raise ValueError(f"wo {p['wo'].shape} / bo {p['bo'].shape} must be "
                         f"({W}, 1) / (1,)")
    p["y_scale"] = p["y_scale"].reshape(())
    # the features are the target lags alone (Table 1): mu/sd take their
    # count from the model object
    return device_version(model_object, p,
                          np.asarray(model_object["mu"]).shape[0], device)


class LSTMForecaster(ForecastModelBase):
    """Sequence model: features are the raw 24-lag window (Table 1)."""
    KIND = "LSTM"
    SUPPORTS_FLEET = True
    DEFAULTS = {**ForecastModelBase.DEFAULTS,
                "hidden": 32, "epochs": 200, "lr": 1e-3,
                "target_lags": 24, "use_weather": False, "use_calendar": False}

    def _fit(self, X, y, rng):
        """One instance is a bin of one (see ``ANNForecaster._fit``)."""
        up = {**self.DEFAULTS, **self.user_params}
        stacked = self._fleet_fit(X[None], y[None], rng, up,
                                  self.system.device)
        return {k: v[0] for k, v in stacked.items()}

    def _predict(self, params, X):
        single = X.ndim == 1
        stacked = {k: v[None] for k, v in params.items()}
        # rows are standardized [lag1..lagL]; reverse to time order
        out = _fleet_lstm_out(stacked, torch.atleast_2d(X).flip(-1)[None],
                              stacked["y_scale"])[0].cpu().numpy()
        return out[0] if single else out

    @classmethod
    def _fleet_fit(cls, X, y, rng, up, device):
        # bin-shared user_params, NOT redeclared defaults (fleet == local)
        width = int(up["hidden"])
        epochs, lr = int(up["epochs"]), float(up["lr"])
        ys = to_device(np.abs(to_host(y)).max(axis=1) * 1.2 + 1e-6, device)
        seqs = to_device(X, device).flip(-1)         # lag order -> time order
        y = to_device(y, device)
        init = _init_fleet(int(rng.integers(2**31)), seqs.shape[0], width,
                           device)

        def loss(p):
            # each instance's own mean, summed over the bin (see ann.py)
            return (_fleet_lstm_out(p, seqs, ys) - y).square().mean(
                dim=1).sum()

        params = fit_adam(init, loss, epochs, lr)
        params["y_scale"] = ys
        return params

    @classmethod
    def _fleet_window_predict(cls, stacked, X):
        # whole training window per instance in one stacked forward pass:
        # rows become the LSTM batch axis, lags reversed to time order
        seqs = to_device(X, stacked["wo"].device).flip(-1)
        with torch.no_grad():
            out = _fleet_lstm_out(stacked, seqs, stacked["y_scale"])
        return out.cpu().numpy().astype(np.float64)

    @classmethod
    def _fleet_predict_traced(cls, stacked, x):
        seqs = x.flip(-1)[:, None, :]        # lag order -> time order
        return _fleet_lstm_out(stacked, seqs, stacked["y_scale"])[:, 0]

    @classmethod
    def _device_predict_factory(cls, spec, statics):
        return cls._fleet_predict_traced
