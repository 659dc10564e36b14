"""Faults planted under the timed path, to show that the check catches
each that the cells can have (the tests on the CPU, ``control.py`` on
the card):

* ``state_unchanged``: the fit returns its initial weights;
* ``half_batch``: the fit's loss is the mean over the first half of each
  instance's rows alone; the design, its standardisation and the output
  scale stay whole, as does the residual band worked out after the fit;
* ``answer_altered``: ``fleet_mlp``'s output for the bin's first instance
  is altered where it is produced, at every step, so that the forecast
  moves by 1 % of the fit's output scale (the raw output is moved to the
  logit of its sigmoid shifted by 0.01 towards 0.5);
* ``fit_tf32``: the fit's products on the tensor cores in TF32, the
  rollout and the band left in float32 (the program's own path in the
  control's precision, where a change to the fit alone would put it).

The cells run on one card, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "fit_tf32")


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.forecast import ann
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    saved = {"fit_adam": ann.fit_adam, "fleet_mlp": ann.fleet_mlp,
             "_fleet_fit": ann.ANNForecaster.__dict__["_fleet_fit"]}
    if fault == "state_unchanged":
        ann.fit_adam = lambda params, loss_fn, epochs, lr: {
            k: v.detach().clone() for k, v in params.items()}
    elif fault == "half_batch":
        ann.ANNForecaster._fleet_fit = classmethod(_half_loss_fit)
    elif fault == "fit_tf32":
        orig = saved["fit_adam"]

        def tf32_fit(params, loss_fn, epochs, lr):
            from .check import matmul_tf32
            with matmul_tf32(True):
                return orig(params, loss_fn, epochs, lr)

        ann.fit_adam = tf32_fit
    else:
        orig = saved["fleet_mlp"]

        def altered(x, ws, bs):
            import torch
            out = orig(x, ws, bs).clone()
            p = torch.sigmoid(out[0])
            out[0] = torch.logit(torch.where(p < 0.5, p + 0.01, p - 0.01))
            return out

        ann.fleet_mlp = altered
    try:
        yield
    finally:
        ann.fit_adam, ann.fleet_mlp = saved["fit_adam"], saved["fleet_mlp"]
        ann.ANNForecaster._fleet_fit = saved["_fleet_fit"]


def _half_loss_fit(cls, X, y, rng, up, device, mesh=None):
    """The program's ``ANNForecaster._fleet_fit`` on one device, its loss
    taken over the first half of each instance's rows."""
    import numpy as np
    from repro_torch.forecast import ann
    from repro_torch.forecast.base import to_device, to_host
    ys = to_device(np.abs(to_host(y)).max(axis=1) * 1.2 + 1e-6, device)
    X, y = to_device(X, device), to_device(y, device)
    init = ann._init_fleet(int(rng.integers(2**31)), X.shape[0], X.shape[-1],
                           int(up["hidden"]), device)
    h = X.shape[1] // 2

    def loss(p):
        return (ann._fleet_mlp_out(p, X[:, :h], ys) - y[:, :h]).square() \
            .mean(dim=1).sum()

    params = ann.fit_adam(init, loss, int(up["epochs"]), float(up["lr"]))
    params["y_scale"] = ys
    return params
