"""Whether what the timed path produced is correct: the program's
persisted versions and forecasts, against the plain reference
(``reference/ann.py``) worked out from the same readings and weather.

Two stages are judged, each on a sample drawn from the seed:

* the fit: versions of sampled (train tick, deployment) pairs. The
  reference fits them again from the readings, from the same initial
  weights (the one law of ``reference.ann.initial_weights``), and is
  compared by its leaves and their change (``fit_numbers``) and by its
  standardisation and output scales (``fit_scales``); the residual band
  is worked out from the program's weights and compared (``fit_band``).
  Of the window's fits, those of sampled train ticks are also followed
  through their first steps: the reference takes the tick's whole bin
  through the same steps from the same weights, and each step's loss, as
  the program's fit computed it (``driver.FitTap``), is compared with the
  reference's (``fit_loss``);
* the rollout through ``fleet_mlp``: every deployment's persisted
  forecast and band at sampled score ticks (the last one always). The
  reference rolls each out from the history it aligns itself, with the
  version that the program scored with (the fit stage is judged above),
  and is compared by the widest gap over the horizon (``forecast``).

Every job of the window must have succeeded and every sampled answer
must be there (``missing``, limit 0).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np

from ..reference import ann as ref
from .driver import FitTap
from .site import DAY, HOUR

LEAVES = ("w0", "w1", "w2", "w3", "w4", "b0", "b1", "b2", "b3", "b4")


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """TF32 products on (the control's precision) or off."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _clone(t):
    return t.detach().clone()


def gather(flow, run, seed: int) -> dict:
    """The program's answers the check reads, copied out of the system
    (so that its state can be freed before the reference runs)."""
    import torch
    cell, c = flow.cell, flow.castor
    cfg, prm = cell.config, cell.params
    rng = np.random.default_rng([seed, 7])
    names = [d.name for d in flow.deployments]
    n = len(names)
    window_trains = [t.now for t in run.ticks if t.trained]
    if window_trains:
        train_nows, epochs = window_trains, cfg["epochs"]
    else:
        train_nows = [flow.t_first]
        epochs = cfg["setup_epochs"]
    k = min(prm["fit_instances"], n)
    rows = rng.choice(n, k, replace=False)
    nows = rng.choice(train_nows, k)
    missing = 0
    fits = []
    for r, now in zip(rows, nows):
        mv = c.versions.get(names[r], at=now)
        if mv is None or mv.trained_at != now:
            missing += 1
            continue
        mo = mv.params
        fits.append({"row": int(r), "now": float(now),
                     "params": {k_: _clone(mo["params"][k_]) for k_ in LEAVES},
                     "fit_scale": float(mo["params"]["y_scale"]),
                     "mu": mo["mu"].double().cpu().numpy(),
                     "sd": mo["sd"].double().cpu().numpy(),
                     "y_scale": float(mo["y_scale"]),
                     "resid_q": np.asarray(mo["resid_q"], np.float64)})
    taps = [(t.now, f) for t in run.ticks if t.trained for f in t.fits]
    picked = rng.choice(len(taps), min(prm.get("loss_ticks", 0), len(taps)),
                        replace=False) if taps else []
    losses = [{"now": float(taps[i][0]), "n": taps[i][1]["n"],
               "steps": min(FitTap.LOSS_STEPS, taps[i][1]["epochs"]),
               "losses": taps[i][1]["losses"]} for i in sorted(picked)]
    score_nows = [t.now for t in run.ticks if t.scored]
    picks = []
    if score_nows:
        m = min(prm["forecast_ticks"], len(score_nows)) - 1
        picks = sorted(rng.choice(score_nows[:-1], m, replace=False).tolist()
                       if m > 0 else []) + [score_nows[-1]]
    history = {nm: {f.created_at: f for f in c.predictions.history(nm)}
               for nm in names} if picks else {}
    stacks: Dict[tuple, dict] = {}
    forecasts = []
    for now in picks:
        got = [history[nm].get(now) for nm in names]
        mvs = [c.versions.get(nm, at=now) for nm in names]
        if any(g is None for g in got) or any(v is None for v in mvs):
            missing += sum(g is None for g in got)
            continue
        key = tuple(v.trained_at for v in mvs)
        if key not in stacks:
            mos = [v.params for v in mvs]
            stacks[key] = {
                "params": {k_: torch.stack([mo["params"][k_] for mo in mos])
                           for k_ in mos[0]["params"]},
                "mu": torch.stack([mo["mu"] for mo in mos]),
                "sd": torch.stack([mo["sd"] for mo in mos]),
                "resid_q": np.stack([np.asarray(mo["resid_q"], np.float64)
                                     for mo in mos])}
        forecasts.append({"now": float(now), "version": key,
                          "values": np.stack([g.values for g in got]),
                          "lower": np.stack([g.lower for g in got]),
                          "upper": np.stack([g.upper for g in got])})
    return {"n": n, "epochs": int(epochs), "fits": fits, "losses": losses,
            "forecasts": forecasts, "stacks": stacks, "missing": missing,
            "failed": sum(t.failed for t in run.ticks)}


def _window(flow, rows, now: float):
    """The reference's training inputs at ``now`` for ``rows``: aligned
    targets and observed temperatures over the train window."""
    cfg, site = flow.cell.config, flow.site
    T = int(cfg["train_window_days"] * 24)
    t0 = now - cfg["train_window_days"] * DAY
    ts, vals = site.readings(t0, now)
    y = ref.hourly_window(ts[rows], vals[rows], t0, T)
    grid = t0 + HOUR * np.arange(T)
    temps = site.temperature(rows, grid)
    return y, temps, grid


def _designs(flow, fits: List[dict], f32_inputs: bool = False):
    """The sampled fits' standardised designs ``(k, R, F)`` (float32 on
    the device), targets ``(k, R)`` float64, ``mu`` and ``sd``.
    ``f32_inputs`` standardises in float32 on the device instead of
    float64 on the host, as the program's warm path does."""
    import torch
    dev, lags = flow.device, flow.cell.config["target_lags"]
    Xs, ys, mus, sds = [], [], [], []
    for f in fits:
        y, temps, grid = _window(flow, [f["row"]], f["now"])
        X, target = ref.design(y, temps, grid, lags)
        Xs_, mu, sd = ref.standardise(X)
        if f32_inputs:
            Xf = torch.as_tensor(X, dtype=torch.float32, device=dev)
            Xs_ = (Xf - Xf.mean(dim=1, keepdim=True)) / (
                Xf.std(dim=1, correction=0, keepdim=True) + 1e-8)
        Xs.append(torch.as_tensor(Xs_[0], dtype=torch.float32, device=dev))
        ys.append(target[0]), mus.append(mu[0]), sds.append(sd[0])
    return torch.stack(Xs), np.stack(ys), mus, sds


def reference_fits(flow, out: dict, tf32: bool = False,
                   f32_inputs: bool = False) -> List[dict]:
    """The reference's versions of the sampled fits, each with its
    initial weights (``init``); ``f32_inputs`` as ``_designs``: a witness
    of how far the fit's result moves with the last bit of its inputs."""
    import torch
    cfg, fits = flow.cell.config, out["fits"]
    if not fits:
        return []
    X, y, mus, sds = _designs(flow, fits, f32_inputs)
    sizes = ref.layer_sizes(cfg["n_features"], cfg["hidden"],
                            cfg["hidden_layers"])
    scale = torch.as_tensor(np.abs(y).max(axis=1) * 1.2 + 1e-6,
                            dtype=torch.float32, device=flow.device)
    p0 = ref.initial_weights(out["n"], sizes, [f["row"] for f in fits],
                             flow.device)
    with matmul_tf32(tf32):
        p = ref.fit(p0, X, torch.as_tensor(y, dtype=torch.float32,
                                           device=flow.device),
                    scale, out["epochs"], cfg["lr"])
    return [{"params": {k: v[i] for k, v in p.items()},
             "init": {k: v[i] for k, v in p0.items()},
             "fit_scale": float(scale[i]), "mu": mus[i], "sd": sds[i],
             "y_scale": float(np.abs(y[i]).max() + 1e-6)}
            for i in range(len(fits))]


def reference_losses(flow, out: dict, tf32: bool = False) -> List[list]:
    """Each step's loss of the reference over the whole bin of each
    sampled train tick (``out["losses"]``), through the steps that the
    program's fit is followed, from the same initial weights."""
    import torch
    cfg, f32, dev = flow.cell.config, torch.float32, flow.device
    sizes = ref.layer_sizes(cfg["n_features"], cfg["hidden"],
                            cfg["hidden_layers"])
    res = []
    for rec in out["losses"]:
        rows = np.arange(rec["n"])
        y, temps, grid = _window(flow, rows, rec["now"])
        X, target = ref.design(y, temps, grid, cfg["target_lags"])
        X = torch.as_tensor(ref.standardise(X)[0], dtype=f32, device=dev)
        scale = torch.as_tensor(np.abs(target).max(axis=1) * 1.2 + 1e-6,
                                dtype=f32, device=dev)
        p0 = ref.initial_weights(rec["n"], sizes, rows, dev)
        got = []
        with matmul_tf32(tf32):
            ref.fit(p0, X, torch.as_tensor(target, dtype=f32, device=dev),
                    scale, rec["steps"], cfg["lr"], got)
        del X, p0
        res.append(got)
    return res


def loss_gaps(got: List[list], want: List[list]) -> List[float]:
    """The gap between each step's loss and the reference's, relative,
    the widest over the sampled ticks; a fit that never computed its loss
    reads 1 at every step."""
    steps = max(len(r) for r in want)
    gaps = [0.0] * steps
    for g, r in zip(got, want):
        if len(g) < len(r):
            return [1.0] * steps
        for i, (a, b) in enumerate(zip(g, r)):
            gaps[i] = max(gaps[i], abs(a - b) / abs(b))
    return gaps


def loss_number(got: List[list], want: List[list]) -> float:
    """``fit_loss``: the widest of ``loss_gaps``."""
    return max(loss_gaps(got, want))


def reference_bands(flow, out: dict, tf32: bool = False) -> np.ndarray:
    """The residual band of each sampled fit worked out by the reference
    from the program's weights and output scale (the band's stage on its
    own): ``(k, 2)``."""
    import torch
    fits = out["fits"]
    X, y, _, _ = _designs(flow, fits)
    p = {k: torch.stack([f["params"][k] for f in fits]) for k in LEAVES}
    scale = torch.as_tensor([f["fit_scale"] for f in fits],
                            dtype=torch.float32, device=flow.device)
    with matmul_tf32(tf32):
        return ref.residual_band(p, X, y, scale, tf32_operands=tf32)


def reference_forecasts(flow, out: dict, tf32: bool = False) -> List[dict]:
    """The reference's rollout of every sampled score tick, with the
    versions the program scored with."""
    import torch
    cfg, site = flow.cell.config, flow.site
    H, lags = cfg["horizon"], cfg["target_lags"]
    rows = np.arange(out["n"])
    f32 = torch.float32
    res = []
    for f in out["forecasts"]:
        st = out["stacks"][f["version"]]
        now = f["now"]
        y, _, _ = _window(flow, rows, now)
        fut = now + HOUR * np.arange(H)
        temps = torch.as_tensor(site.forecast(rows, now, fut), dtype=f32,
                                device=flow.device)
        p = {k: v for k, v in st["params"].items() if k != "y_scale"}
        with matmul_tf32(tf32):
            vals = ref.rollout(p, st["params"]["y_scale"], st["mu"], st["sd"],
                               torch.as_tensor(y[:, -lags:], dtype=f32,
                                               device=flow.device),
                               temps, fut, tf32_operands=tf32)
        v = vals.double().cpu().numpy()
        lo, hi = ref.bands(v, st["resid_q"])
        res.append({"values": v, "lower": lo, "upper": hi,
                    "scale": np.abs(y).max(axis=1) + 1e-6})
    return res


def fit_numbers(got: List[dict], want: List[dict]) -> Dict[str, float]:
    """``got`` and ``want`` hold versions in one form: the leaves, the
    fit's output scale, ``mu``/``sd`` in float64, the series' ``y_scale``;
    ``want`` (the reference's) also the initial weights. Each number is the
    worst over the sampled versions:

    * ``fit_weights``: the norm of a leaf's difference, over the larger
      of the leaf's norm and the median leaf's;
    * ``fit_move_total``: the gap between the norms of all the weights'
      change, over the reference's (a fit that moved nothing reads 1);
    * ``fit_scales``: standardisation and output scales, relative."""
    import torch

    def norm(t) -> float:
        return float(torch.linalg.vector_norm(t))

    w = tot = s = 0.0
    for g, r in zip(got, want):
        p, q, p0 = g["params"], r["params"], r["init"]
        size = {k: norm(q[k]) for k in LEAVES}
        move = {k: norm(q[k] - p0[k]) for k in LEAVES}
        moved = {k: norm(p[k].float() - p0[k]) for k in LEAVES}
        med = float(np.median(list(size.values())))
        for k in LEAVES:
            w = max(w, norm(p[k].float() - q[k]) / max(size[k], med))
        whole = np.sqrt(sum(v * v for v in move.values()))
        tot = max(tot, abs(np.sqrt(sum(v * v for v in moved.values()))
                           - whole) / whole)
        s = max(s, float(np.max(np.abs(g["mu"] - r["mu"]) / r["sd"])),
                float(np.max(np.abs(g["sd"] - r["sd"]) / r["sd"])),
                abs(g["y_scale"] - r["y_scale"]) / r["y_scale"],
                abs(g["fit_scale"] - r["fit_scale"]) / r["fit_scale"])
    return {"fit_weights": w, "fit_move_total": tot, "fit_scales": s}


def band_number(fits: List[dict], rq: np.ndarray) -> float:
    """``fit_band``: the widest gap between a version's residual band and
    ``rq``, over its series' scale."""
    return max(float(np.max(np.abs(f["resid_q"] - r))) / f["y_scale"]
               for f, r in zip(fits, rq))


def forecast_numbers(got: List[dict], want: List[dict]) -> Dict[str, float]:
    """The widest gap of a forecast's values or band, over its series'
    scale, over every sampled forecast."""
    gap = 0.0
    for g, r in zip(got, want):
        for k in ("values", "lower", "upper"):
            gap = max(gap, float(np.max(np.abs(g[k] - r[k])
                                        / r["scale"][:, None])))
    return {"forecast": gap}


def numbers(flow, out: dict) -> Dict[str, float]:
    """Every number the check can compare, for the program's answers."""
    nums = {"missing": float(out["missing"] + out["failed"])}
    if out["fits"]:
        nums.update(fit_numbers(out["fits"], reference_fits(flow, out)))
        nums["fit_band"] = band_number(out["fits"],
                                       reference_bands(flow, out))
    if out["losses"]:
        nums["fit_loss"] = loss_number([r["losses"] for r in out["losses"]],
                                       reference_losses(flow, out))
    if out["forecasts"]:
        nums.update(forecast_numbers(out["forecasts"],
                                     reference_forecasts(flow, out)))
    return nums


def control_numbers(flow, out: dict) -> Dict[str, float]:
    """The same numbers with the reference in TF32 put in the program's
    place (the fit with TF32 products, the band and the rollout with each
    product's operands rounded to TF32); and, as ``witness.*``, the
    reference's fit against itself with its design standardised in
    float32."""
    nums = {}
    if out["fits"]:
        want = reference_fits(flow, out)
        nums.update(fit_numbers(reference_fits(flow, out, tf32=True), want))
        nums.update({f"witness.{k}": v for k, v in fit_numbers(
            reference_fits(flow, out, f32_inputs=True), want).items()})
        rq = reference_bands(flow, out)
        tf = reference_bands(flow, out, tf32=True)
        nums["fit_band"] = band_number(
            [dict(f, resid_q=t) for f, t in zip(out["fits"], tf)], rq)
    if out["losses"]:
        nums["fit_loss"] = loss_number(reference_losses(flow, out, tf32=True),
                                       reference_losses(flow, out))
    if out["forecasts"]:
        nums.update(forecast_numbers(reference_forecasts(flow, out, tf32=True),
                                     reference_forecasts(flow, out)))
    return nums


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` of every number the cell compares,
    and whether each is within its limit."""
    out = {k: {"value": nums.get(k), "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in out.values())
    return {"correct": ok, "checks": out}
