"""Plain reference of the ANN forecast flow that the benchmark's cells run:
hourly alignment of irregular readings, the design matrix of lags,
temperature and calendar features, per-instance standardisation, the fit
(full-batch Adam on a stacked MLP), the residual band, and the recursive
24-step rollout.

Written from the paper's description (Chen et al., Scalable Deployment of
AI Time-series Models for IoT, Sec. 4.2) and the forecast semantics the
benchmark holds the program to, in numpy (float64) and plain torch
(float32 products, TF32 off). It imports nothing of the program. The
benchmark hands it the same readings and weather tables that it hands the
program; what the program derived from them, it works out again.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

HOUR = 3600.0
DAY = 24 * HOUR
BAND_QUANTILES = (0.1, 0.9)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
#: the fit's initial weights follow one law: every fleet draws them from a
#: ``torch.Generator`` on its device seeded with the first draw of
#: ``numpy.random.default_rng(INIT_RNG_SEED).integers(2**31)``, layer after
#: layer, ``randn(n, d_in, d_out) * sqrt(2 / d_in)`` for the weights and
#: zeros for the biases, over all ``n`` instances of the bin at once
INIT_RNG_SEED = 12345


def hourly_window(ts: np.ndarray, vals: np.ndarray, t0: float,
                  n_bins: int) -> np.ndarray:
    """Readings on the hourly grid ``[t0 + k h, t0 + (k + 1) h)``,
    ``k < n_bins``: each bin the mean of its readings; an empty bin the
    value of the last filled bin before it in the window, 0 before the
    first. ``ts``/``vals`` are ``(N, K)``, absent readings with a NaN
    time. Returns ``(N, n_bins)`` float64."""
    n = ts.shape[0]
    with np.errstate(invalid="ignore"):
        idx = np.floor((ts - t0) / HOUR)
    ok = np.isfinite(idx) & (idx >= 0) & (idx < n_bins)
    rows = np.broadcast_to(np.arange(n)[:, None], ts.shape)[ok]
    flat = rows * n_bins + idx[ok].astype(np.int64)
    sums = np.bincount(flat, weights=vals[ok], minlength=n * n_bins)
    cnts = np.bincount(flat, minlength=n * n_bins)
    sums, cnts = sums.reshape(n, n_bins), cnts.reshape(n, n_bins)
    mean = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
    last = np.maximum.accumulate(
        np.where(cnts > 0, np.arange(n_bins), -1), axis=1)
    took = np.take_along_axis(mean, np.maximum(last, 0), axis=1)
    return np.where(last >= 0, took, 0.0)


def calendar(times: np.ndarray) -> np.ndarray:
    """Hour-of-day and day-of-week encodings: ``(T, 5)`` float64."""
    t = np.asarray(times, np.float64)
    hod, dow = (t % DAY) / HOUR, (t // DAY) % 7
    return np.stack([np.sin(2 * np.pi * hod / 24), np.cos(2 * np.pi * hod / 24),
                     np.sin(2 * np.pi * dow / 7), np.cos(2 * np.pi * dow / 7),
                     (dow >= 5).astype(np.float64)], axis=1)


def design(y: np.ndarray, temps: np.ndarray, grid: np.ndarray,
           lags: int):
    """Rows ``t = lags .. T - 1`` of each instance: the target's lags 1 to
    ``lags``, the temperature at ``t`` and the calendar at ``t``;
    the target at ``t``. ``y``/``temps`` ``(N, T)``. Returns ``X (N, T -
    lags, lags + 6)`` and ``target (N, T - lags)``, float64."""
    T = y.shape[1]
    cols = [y[:, lags - L:T - L] for L in range(1, lags + 1)]
    X = np.concatenate([np.stack(cols, axis=-1), temps[:, lags:, None],
                        np.broadcast_to(calendar(grid[lags:]),
                                        (y.shape[0], T - lags, 5))], axis=-1)
    return X, y[:, lags:]


def standardise(X: np.ndarray):
    """Per-instance feature mean and standard deviation (+ 1e-8)."""
    mu = X.mean(axis=1)
    sd = X.std(axis=1) + 1e-8
    return (X - mu[:, None, :]) / sd[:, None, :], mu, sd


def layer_sizes(n_features: int, width: int, hidden_layers: int) -> List[int]:
    return [n_features] + [width] * hidden_layers + [1]


def initial_weights(n: int, sizes: Sequence[int], rows, device) -> Dict:
    """The rows ``rows`` of a fleet of ``n`` instances' initial weights
    (see ``INIT_RNG_SEED``)."""
    seed = int(np.random.default_rng(INIT_RNG_SEED).integers(2**31))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = torch.as_tensor(np.asarray(rows), device=device)
    out = {}
    for i in range(len(sizes) - 1):
        w = torch.randn((n, sizes[i], sizes[i + 1]), generator=g,
                        device=device) * math.sqrt(2.0 / sizes[i])
        out[f"w{i}"] = w[rows].clone()
        del w
        out[f"b{i}"] = torch.zeros((len(rows), sizes[i + 1]), device=device)
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest: what
    the tensor cores make of a product's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mlp(p: Dict, x: torch.Tensor, tf32_operands: bool = False) -> torch.Tensor:
    """Raw output ``(N, R)`` of the stacked MLP on ``x (N, R, F)``: ReLU
    between layers, the last layer linear. ``tf32_operands`` rounds each
    product's operands to TF32 first (the control's precision, whatever
    kernel the library picks for the product)."""
    depth = sum(k.startswith("w") for k in p)
    r = tf32 if tf32_operands else (lambda t: t)
    h = x
    for i in range(depth):
        h = torch.bmm(r(h), r(p[f"w{i}"])) + p[f"b{i}"][:, None, :]
        if i < depth - 1:
            h = torch.relu(h)
    return h[..., 0]


def predict(p: Dict, x: torch.Tensor, scale: torch.Tensor,
            tf32_operands: bool = False) -> torch.Tensor:
    """Sigmoid output in physical units: ``sigmoid(mlp) * scale``."""
    return torch.sigmoid(mlp(p, x, tf32_operands)) * scale[:, None]


def fit(p0: Dict, X: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
        epochs: int, lr: float, losses: list = None) -> Dict:
    """Full-batch Adam from ``p0`` on the sum over instances of each
    instance's mean squared error, so that each instance follows its own
    path: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps). Each step's
    loss, before its update, is appended to ``losses`` where given."""
    b1, b2 = ADAM_BETAS
    names = list(p0)
    ps = [p0[k].detach().clone().requires_grad_(True) for k in names]
    ms = [torch.zeros_like(q) for q in ps]
    vs = [torch.zeros_like(q) for q in ps]
    for t in range(1, epochs + 1):
        loss = (predict(dict(zip(names, ps)), X, scale) - y).square() \
            .mean(dim=1).sum()
        if losses is not None:
            losses.append(float(loss.detach()))
        grads = torch.autograd.grad(loss, ps)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for q, m, v, g in zip(ps, ms, vs, grads):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                q.sub_(lr * (m / c1) / ((v / c2).sqrt() + ADAM_EPS))
    return {k: q.detach() for k, q in zip(names, ps)}


def residual_band(p: Dict, X: torch.Tensor, y: np.ndarray,
                  scale: torch.Tensor, tf32_operands: bool = False
                  ) -> np.ndarray:
    """q10 / q90 of each instance's one-step training residuals:
    ``(N, 2)`` float64."""
    with torch.no_grad():
        yhat = predict(p, X, scale, tf32_operands).double().cpu().numpy()
    return np.quantile(y - yhat, BAND_QUANTILES, axis=1).T


def rollout(p: Dict, scale: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
            y_hist: torch.Tensor, temps_future: torch.Tensor,
            times_future: np.ndarray, tf32_operands: bool = False
            ) -> torch.Tensor:
    """Recursive forecast: each step's features are the last ``lags``
    values (observed, then forecast), the weather forecast for the step
    and its calendar; the prediction feeds the next step. ``y_hist``
    ``(N, lags)`` newest last, ``temps_future (N, H)``. Returns
    ``(N, H)``."""
    lags = y_hist.shape[1]
    cal = torch.as_tensor(calendar(times_future), dtype=y_hist.dtype,
                          device=y_hist.device)
    n = y_hist.shape[0]
    window = y_hist
    out = []
    with torch.no_grad():
        for h in range(times_future.size):
            x = torch.cat([window.flip(-1), temps_future[:, h:h + 1],
                           cal[h].expand(n, 5)], dim=-1)
            yh = predict(p, ((x - mu) / sd)[:, None, :], scale,
                         tf32_operands)[:, 0]
            out.append(yh)
            window = torch.cat([window[:, 1:], yh[:, None]], dim=1)
    return torch.stack(out, dim=1)


def bands(values: np.ndarray, resid_q: np.ndarray):
    """Lower and upper band: the residual quantiles widened by
    sqrt(1 + h) at step h."""
    widen = np.sqrt(1.0 + np.arange(values.shape[-1]))
    return (values + resid_q[:, 0:1] * widen, values + resid_q[:, 1:2] * widen)
