"""ANN forecaster (paper §4.2), scoring half: MLP with 4 hidden ReLU layers
and a sigmoid output. Paper width 512; ``hidden`` is user-configurable so
CPU tests stay fast. Fleet scoring = the fleet_mlp kernel (per-instance
weights megabatch — the paper's serving hot-spot). Training is not ported
yet (see ``base.TRAINING_NOT_PORTED``); versions trained elsewhere arrive
through ``ann_version_from_numpy``."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fleet_mlp.ops import fleet_mlp
from .base import ForecastModelBase

N_HIDDEN_LAYERS = 4
N_LAYERS = N_HIDDEN_LAYERS + 1


def _mlp_out(params, X):
    """Plain per-instance forward: X (..., F) -> (...,) physical units."""
    h = X
    for i in range(N_LAYERS):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < N_LAYERS - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0]) * params["y_scale"]


def ann_version_from_numpy(model_object: dict, device) -> dict:
    """Convert an ANN version in the persisted numpy layout —
    ``{"kind": "ANN", "params": {w0..w4, b0..b4, y_scale}, "mu", "sd",
    "y_scale", "resid_q"}`` — into the port's model object, its tensors f32
    on ``device``. Raises ``ValueError`` on any other layout or on shapes
    that do not chain."""
    if model_object.get("kind") != ANNForecaster.KIND:
        raise ValueError(f"not an ANN version: kind={model_object.get('kind')!r}")
    p = model_object["params"]
    want = {f"w{i}" for i in range(N_LAYERS)} | \
        {f"b{i}" for i in range(N_LAYERS)} | {"y_scale"}
    if set(p) != want:
        raise ValueError(f"ANN params must be {sorted(want)}, got {sorted(p)}")
    ws = [np.asarray(p[f"w{i}"]) for i in range(N_LAYERS)]
    bs = [np.asarray(p[f"b{i}"]) for i in range(N_LAYERS)]
    width = ws[0].shape[0] if ws[0].ndim == 2 else -1
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.ndim != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w{i} {w.shape} / b{i} {b.shape} do "
                             f"not chain from width {width}")
        width = w.shape[1]
    if width != 1:
        raise ValueError(f"the last layer must have width 1, got {width}")
    n_features = ws[0].shape[0]
    mu, sd = np.asarray(model_object["mu"]), np.asarray(model_object["sd"])
    if mu.shape != (n_features,) or sd.shape != (n_features,):
        raise ValueError(f"mu {mu.shape} / sd {sd.shape} must be "
                         f"({n_features},)")
    resid_q = np.asarray(model_object["resid_q"], np.float64)
    if resid_q.shape != (2,):
        raise ValueError(f"resid_q must be (2,), got {resid_q.shape}")

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    params = {f"w{i}": dev(w) for i, w in enumerate(ws)}
    params.update({f"b{i}": dev(b) for i, b in enumerate(bs)})
    params["y_scale"] = dev(p["y_scale"]).reshape(())
    return {"kind": ANNForecaster.KIND, "params": params, "mu": dev(mu),
            "sd": dev(sd), "y_scale": float(model_object["y_scale"]),
            "resid_q": resid_q}


class ANNForecaster(ForecastModelBase):
    KIND = "ANN"
    SUPPORTS_FLEET = True
    DEFAULTS = {**ForecastModelBase.DEFAULTS,
                "hidden": 64, "epochs": 300, "lr": 1e-3,
                "target_lags": 48, "weather_lags": 0}

    def _predict(self, params, X):
        """Plain one-step prediction for one instance (LocalPool path)."""
        return _mlp_out(params, X).cpu().numpy()

    # ------------- fleet hooks -------------
    @classmethod
    def _fleet_predict(cls, stacked, X):
        return cls._fleet_predict_traced(stacked, X).cpu().numpy()

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
