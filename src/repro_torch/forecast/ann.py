"""ANN forecaster (paper §4.2): MLP with 4 hidden ReLU layers and a sigmoid
output, Adam(1e-3). Paper width 512; ``hidden`` is user-configurable so
CPU tests stay fast. Fleet training = one stacked fit with per-instance
Adam (``base.fit_adam``, batched products over the bin); fleet scoring =
the fleet_mlp kernel (per-instance weights megabatch — the paper's
serving hot-spot). Versions in the persisted numpy layout arrive through
``ann_version_from_numpy``."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.fleet_mlp.ops import fleet_mlp
from .base import (ForecastModelBase, device_version, fit_adam, numpy_params,
                   to_device, to_host)

N_HIDDEN_LAYERS = 4
N_LAYERS = N_HIDDEN_LAYERS + 1


def _init_fleet(seed: int, n: int, f_in: int, width: int, device) -> dict:
    """Initial weights of ``n`` instances, stacked: He-normal ``w0..w4``
    ``(n, d_in, d_out)`` and zero ``b0..b4`` ``(n, d_out)``, f32, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed`` (the
    JAX package's initialisation law; tests substitute its values)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = [f_in] + [width] * N_HIDDEN_LAYERS + [1]
    out = {}
    for i in range(N_LAYERS):
        out[f"w{i}"] = torch.randn((n, sizes[i], sizes[i + 1]), generator=g,
                                   device=device) \
            * math.sqrt(2.0 / sizes[i])
        out[f"b{i}"] = torch.zeros((n, sizes[i + 1]), device=device)
    return out


def _fleet_mlp_out(stacked, X, y_scale):
    """Plain forward of a stacked bin: X (N, T, F) -> (N, T) physical
    units, one batched product per layer (the fit's forward, the window
    predictions and, on a bin of one, the single-instance path)."""
    h = X
    for i in range(N_LAYERS):
        h = torch.baddbmm(stacked[f"b{i}"][:, None, :], h, stacked[f"w{i}"])
        if i < N_LAYERS - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0]) * y_scale[:, None]


def ann_version_from_numpy(model_object: dict, device) -> dict:
    """Convert an ANN version in the persisted numpy layout —
    ``{"kind": "ANN", "params": {w0..w4, b0..b4, y_scale}, "mu", "sd",
    "y_scale", "resid_q"}`` — into the port's model object, its tensors f32
    on ``device``. Raises ``ValueError`` on any other layout or on shapes
    that do not chain."""
    p = numpy_params(model_object, ANNForecaster.KIND,
                     [f"w{i}" for i in range(N_LAYERS)]
                     + [f"b{i}" for i in range(N_LAYERS)] + ["y_scale"])
    width = p["w0"].shape[0] if p["w0"].ndim == 2 else -1
    for i in range(N_LAYERS):
        w, b = p[f"w{i}"], p[f"b{i}"]
        if w.ndim != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w{i} {w.shape} / b{i} {b.shape} do "
                             f"not chain from width {width}")
        width = w.shape[1]
    if width != 1:
        raise ValueError(f"the last layer must have width 1, got {width}")
    p["y_scale"] = p["y_scale"].reshape(())
    return device_version(model_object, p, p["w0"].shape[0], device)


class ANNForecaster(ForecastModelBase):
    KIND = "ANN"
    SUPPORTS_FLEET = True
    DEFAULTS = {**ForecastModelBase.DEFAULTS,
                "hidden": 64, "epochs": 300, "lr": 1e-3,
                "target_lags": 48, "weather_lags": 0}

    def _fit(self, X, y, rng):
        """One instance is a bin of one: the same fit, the same arithmetic
        (a version trained by either executor scores on either path)."""
        up = {**self.DEFAULTS, **self.user_params}
        stacked = self._fleet_fit(X[None], y[None], rng, up,
                                  self.system.device)
        return {k: v[0] for k, v in stacked.items()}

    def _predict(self, params, X):
        """Plain one-step prediction for one instance (LocalPool path):
        X (F,) or (T, F)."""
        stacked = {k: v[None] for k, v in params.items()}
        out = _fleet_mlp_out(stacked, torch.atleast_2d(X)[None],
                             stacked["y_scale"])[0]
        return out.cpu().numpy().reshape(X.shape[:-1])

    # ------------- fleet hooks -------------
    @classmethod
    def _fleet_fit(cls, X, y, rng, up, device):
        # bin-shared user_params, NOT redeclared defaults: a deployment with
        # hidden=128 must fleet-train the same width LocalPool would
        width = int(up["hidden"])
        epochs, lr = int(up["epochs"]), float(up["lr"])
        # the sigmoid's scale, not the model object's max|y| + 1e-6
        ys = to_device(np.abs(to_host(y)).max(axis=1) * 1.2 + 1e-6, device)
        X, y = to_device(X, device), to_device(y, device)
        n = X.shape[0]
        init = _init_fleet(int(rng.integers(2**31)), n, X.shape[-1], width,
                           device)

        def loss(p):
            # each instance's own mean over its rows, summed over the bin:
            # every instance gets the gradient of its own loss
            return (_fleet_mlp_out(p, X, ys) - y).square().mean(dim=1).sum()

        params = fit_adam(init, loss, epochs, lr)
        params["y_scale"] = ys
        return params

    @classmethod
    def _fleet_window_predict(cls, stacked, X):
        # full-window forward pass over the stacked bin: (N, T, F) -> (N, T)
        X = to_device(X, stacked["w0"].device)
        with torch.no_grad():
            out = _fleet_mlp_out(stacked, X, stacked["y_scale"])
        return out.cpu().numpy().astype(np.float64)

    @classmethod
    def _fleet_predict_traced(cls, stacked, x):
        """One megabatched fleet_mlp call: per-instance weight stacks with
        a real leading batch dimension (the kernel's grid axis)."""
        ws = [stacked[f"w{i}"] for i in range(N_LAYERS)]
        bs = [stacked[f"b{i}"] for i in range(N_LAYERS)]
        raw = fleet_mlp(x[:, None, :].contiguous(), ws, bs)
        return torch.sigmoid(raw[:, 0, 0]) * stacked["y_scale"]

    @classmethod
    def _device_predict_factory(cls, spec, statics):
        return cls._fleet_predict_traced
