#!/usr/bin/env python3
"""Start the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit; the ``fleet_mlp`` kernel is
   built from the sources in the checkout (seconds and ``ptxas`` lines).
2. kernel: ``fleet_mlp`` on the card against its plain PyTorch version on
   the same inputs, at the scoring shape (N=512, b=1, F=54, width 512,
   depth 5, f32), the unit-test shapes in f32 and bf16, and a ragged
   N=500; the scoring shape is also timed with CUDA events beside its
   bound and the plain version's time.
3. path: ``Castor.tick(executor="fleet")`` over a 512-prosumer site at the
   paper's ANN width (hidden 512), seeded versions, three hourly score
   ticks: every job ok, 24 ``fleet_mlp`` launches per score bin, the
   device rollout entered once per bin, ticks 2-3 on the warm runtime,
   finite forecasts and bands, and a few forecasts held against the
   plain per-instance scoring path.

The last lines are the ``{"kernels": [...]}`` record and the device line.
Without a card, or without ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bandwidth
# and float32 outside the tensor cores (the kernel's FMAs are f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# same tolerances as tests/test_torch_fleet_mlp.py, on |got - ref| / (1 + |ref|)
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# (label, N, b, F, hidden, depth, dtype); the first is the scoring shape
SCORING_CASE = ("scoring", 512, 1, 54, 512, 5, "float32")
TEST_SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1)]
KERNEL_CASES = [SCORING_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate(TEST_SHAPES)] + [
    ("ragged", 500, 1, 54, 512, 5, dt) for dt in ("float32", "bfloat16")]

DAY, HOUR = 86400.0, 3600.0
HORIZON = 24
# tracer spans summed per tick: the tick, the scheduler poll, the score
# bin, its store reads, the runtime's cold build, and the device rollout
# (which ends in the copy of the forecasts to the host)
SPANS = ("castor.tick", "scheduler.poll", "exec.bin", "store.read_many",
         "runtime.build", "rollout.device")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _fleet_inputs(N, b, F, hidden, depth, dtype, device, seed):
    """He-scaled weights so every layer's activations stay O(1)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [F] + [hidden] * (depth - 1) + [1]

    def draw(*shape, scale=1.0):
        t = torch.randn(*shape, generator=g, device=device) * scale
        return t.to(getattr(torch, dtype))

    x = draw(N, b, F)
    ws = [draw(N, sizes[i], sizes[i + 1], scale=(2.0 / sizes[i]) ** 0.5)
          for i in range(depth)]
    bs = [draw(N, sizes[i + 1], scale=0.1) for i in range(depth)]
    return x, ws, bs


def _time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fleet_mlp_bound(x, ws, bs) -> dict:
    """Least time the card could take: each input read once and the output
    written once over HBM, against the f32 multiply-adds over the f32
    peak; the larger of the two bounds it."""
    N, b, _ = x.shape
    out_bytes = N * b * ws[-1].shape[2] * x.element_size()
    nbytes = sum(t.numel() * t.element_size() for t in (x, *ws, *bs)) \
        + out_bytes
    flops = sum(2 * N * b * w.shape[1] * w.shape[2] + N * b * w.shape[2]
                for w in ws)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_phase(device: str, cases=KERNEL_CASES, *, time_it: bool) -> dict:
    """``fleet_mlp`` through its public wrapper against the plain version
    on the same inputs, for every case; returns the scoring case's record
    (error, and with ``time_it`` the CUDA-event times and bound)."""
    import torch
    from repro_torch.kernels.fleet_mlp.ops import fleet_mlp
    from repro_torch.kernels.fleet_mlp.ref import fleet_mlp_reference
    record = None
    for seed, (label, N, b, F, hidden, depth, dtype) in enumerate(cases):
        x, ws, bs = _fleet_inputs(N, b, F, hidden, depth, dtype, device,
                                  seed)
        got = fleet_mlp(x, ws, bs)
        want = fleet_mlp_reference(x, ws, bs)
        if device != "cpu":
            torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label}: kernel gave {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - want.float()).abs()
        rel = float((diff / (1 + want.float().abs())).max())
        max_abs = float(diff.max())
        ok = rel <= TOL[dtype] and bool(torch.isfinite(got.float()).all())
        print(f"kernel {label:8s} N={N} b={b} F={F} width={hidden} "
              f"depth={depth} {dtype}: rel_err={rel:.3e} "
              f"max_abs_err={max_abs:.3e} tol={TOL[dtype]:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"fleet_mlp disagrees with its plain version at {label} "
                  f"{dtype}: {rel:.3e} > {TOL[dtype]:.0e}")
        if label != SCORING_CASE[0]:
            continue
        record = {"max_abs_err": max_abs, "rel_err": rel,
                  **fleet_mlp_bound(x, ws, bs)}
        if time_it:     # in turns: plain, kernel, kernel, plain
            plain = [_time_ms(lambda: fleet_mlp_reference(x, ws, bs), 20)]
            kern = [_time_ms(lambda: fleet_mlp(x, ws, bs), 50)
                    for _ in range(2)]
            plain.append(_time_ms(lambda: fleet_mlp_reference(x, ws, bs), 20))
            record["ms"] = sum(kern) / 2
            record["plain_ms"] = sum(plain) / 2
            print(f"kernel scoring time: {record['ms']:.4f} ms/launch; "
                  f"bound {record['bound_ms']:.4f} ms by {record['bound_by']}"
                  f" ({record['bytes']} bytes, {record['flops']} flop); "
                  f"plain version {record['plain_ms']:.4f} ms; "
                  "library: none (no single PyTorch call computes the "
                  "per-instance chain)")
    return record


def seeded_versions(c, deps, up, device, seed):
    """One ANN version per deployment in the persisted numpy layout,
    converted by ``ann_version_from_numpy``: He-normal weights and zero
    biases (the JAX package's initialisation), ``mu``/``sd`` from each
    instance's own design matrix, the sigmoid scale from its targets, and
    the q10/q90 band of its targets around their mean."""
    import numpy as np
    from repro_torch.forecast import ANNForecaster, ann_version_from_numpy
    from repro_torch.forecast.base import BAND_QUANTILES
    from repro_torch.forecast.features import design_matrix
    rng = np.random.default_rng(seed)
    now = deps[0].score.start
    insts = [ANNForecaster(context=c.graph.context(d.signal, d.entity),
                           task="score", model_id=d.name, model_version=None,
                           user_params={**up, "now": now}, system=c)
             for d in deps]
    ANNForecaster.fleet_load(insts)
    hidden = int(up["hidden"])
    out = {}
    for d, inst in zip(deps, insts):
        spec, grid, target, temps, _ = inst._loaded
        X, y = design_matrix(spec, grid, target, temps)
        sizes = [X.shape[1]] + [hidden] * 4 + [1]
        p = {f"w{i}": rng.standard_normal((sizes[i], sizes[i + 1]),
                                          np.float32)
             * np.float32((2.0 / sizes[i]) ** 0.5) for i in range(5)}
        p.update({f"b{i}": np.zeros(sizes[i + 1], np.float32)
                  for i in range(5)})
        p["y_scale"] = np.abs(y).max() * 1.2 + 1e-6
        mo = {"kind": "ANN", "params": p, "mu": X.mean(0),
              "sd": X.std(0) + 1e-8, "y_scale": float(np.abs(y).max() + 1e-6),
              "resid_q": np.quantile(y - y.mean(), BAND_QUANTILES)}
        out[d.name] = ann_version_from_numpy(mo, device)
    return out


def path_phase(device: str, *, n_prosumers: int = 512, hidden: int = 512,
               n_ticks: int = 3, n_checked: int = 4, seed: int = 11) -> dict:
    """Drive ``Castor.tick(executor="fleet")`` and check what it did.
    Returns the per-tick records and the ``fleet_mlp`` launch total."""
    import numpy as np
    import torch
    from repro_torch.core import Castor, Schedule
    from repro_torch.forecast import ANNForecaster
    from repro_torch.kernels.fleet_mlp import ops
    from repro_torch.timeseries.ingest import SiteSpec, build_site
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t = time.perf_counter()
    c = Castor(device=device)
    info = build_site(c, SiteSpec("SITE", n_prosumers=n_prosumers,
                                  n_feeders=8, n_substations=1, seed=seed),
                      t0=0.0, t1=41 * DAY)
    c.publish("ann", "1.0", ANNForecaster)
    up = {"hidden": hidden, "train_window_days": 28, "horizon": HORIZON}
    deps = c.deploy_for_all(package="ann", signal="ENERGY_LOAD",
                            name_prefix="ann", kind="PROSUMER",
                            score=Schedule(40 * DAY, HOUR), train=None,
                            user_params=up)
    check(len(deps) == n_prosumers, f"{len(deps)} deployments")
    versions = seeded_versions(c, deps, up, device, seed)
    for name, mo in versions.items():
        c.versions.save(name, mo, trained_at=40 * DAY - HOUR)
    sync()
    print(f"path setup: {info['readings']} readings, {len(deps)} ANN "
          f"deployments (hidden {hidden}), seeded versions, "
          f"{time.perf_counter() - t:.1f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    ticks = []
    ops.reset_invocation_count()
    for k in range(n_ticks):
        now = 40 * DAY + k * HOUR
        before = ops.invocation_count()
        c.tracer.clear()
        t = time.perf_counter()
        results = c.tick(now, executor="fleet")
        sync()
        secs = time.perf_counter() - t
        stats = c.fleet_executor().last_bin_stats
        spans = {}
        for sp in c.tracer.spans():
            if sp.name in SPANS:
                spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration
        rec = {"tick": k + 1, "seconds": secs, "jobs": len(results),
               "ok": sum(r.ok for r in results),
               "launches": ops.invocation_count() - before,
               "bins": len(stats),
               "runtime": [s["runtime"] for s in stats],
               "reasons": [s.get("runtime_reason", "") for s in stats],
               "rollouts": [s["rollout_cache_hits"] + s["rollout_cache_misses"]
                            for s in stats],
               "spans": spans}
        ticks.append(rec)
        print(f"tick {k + 1}: {secs:.3f} s wall, jobs {rec['ok']}/"
              f"{rec['jobs']} ok, fleet_mlp launches {rec['launches']} "
              f"over {rec['bins']} score bin(s), runtime {rec['runtime']}")
        print(f"tick {k + 1} spans (host clock, s): " + ", ".join(
            f"{name} {spans.get(name, 0.0):.4f}" for name in SPANS))
        errors = [r.error for r in results if not r.ok]
        check(not errors, f"tick {k + 1}: failed jobs, first: {errors[:1]}")
    launches = ops.invocation_count()

    for rec in ticks:
        k = rec["tick"]
        check(rec["jobs"] == n_prosumers, f"tick {k}: {rec['jobs']} jobs")
        check(rec["launches"] == HORIZON * rec["bins"] and rec["bins"] >= 1,
              f"tick {k}: {rec['launches']} fleet_mlp launches for "
              f"{rec['bins']} score bins")
        # the device rollout ran once per bin: a fallback to the host loop
        # skips it, a runtime that gave up repeats it on the cold path
        check(all(r == 1 for r in rec["rollouts"]),
              f"tick {k}: device rollouts per bin {rec['rollouts']}")
        want = ["cold"] if k == 1 else ["warm"]
        check(rec["runtime"] == want * rec["bins"],
              f"tick {k}: runtime {rec['runtime']} {rec['reasons']}")
    check(ticks[0]["reasons"] == ["first load"] * ticks[0]["bins"],
          f"tick 1: runtime reasons {ticks[0]['reasons']}")
    check(not c.fleet_executor().runtime._no_rollout,
          "the runtime gave up its device rollout")

    last = 40 * DAY + (n_ticks - 1) * HOUR
    for d in deps:
        fc = c.predictions.latest(d.signal, d.entity)
        check(fc is not None and fc.created_at == last,
              f"{d.name}: no forecast from the last tick")
        for arr in (fc.values, fc.lower, fc.upper):
            check(arr is not None and arr.shape == (HORIZON,)
                  and bool(np.isfinite(arr).all()),
                  f"{d.name}: forecast or band not finite / not ({HORIZON},)")
    # the fleet path (kernel, device rollout) against the plain
    # per-instance path (plain MLP, host recursion) on the same versions
    worst = 0.0
    for d in deps[:n_checked]:
        inst = ANNForecaster(context=c.graph.context(d.signal, d.entity),
                             task="score", model_id=d.name,
                             model_version=None,
                             user_params={**up, "now": last}, system=c)
        times, vals, lo, hi = inst.score(versions[d.name])
        fc = c.predictions.latest(d.signal, d.entity)
        np.testing.assert_array_equal(times, fc.times)
        for got, want in ((fc.values, vals), (fc.lower, lo), (fc.upper, hi)):
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)
            worst = max(worst, float(np.max(np.abs(got - want))))
    print(f"path check: {n_checked} forecasts and bands match the plain "
          f"per-instance path (max |diff| {worst:.3e}; rtol 2e-3, atol 1e-3)")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        print(f"path peak device memory: {peak} bytes "
              f"(torch.cuda.max_memory_allocated over the ticks)")
    print(f"path cut: none ({n_prosumers} prosumers, hidden {hidden}, "
          f"{n_ticks} ticks)")
    return {"ticks": ticks, "launches": launches, "peak_bytes": peak}


def _card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip()


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fleet_mlp import kernel

    print(_card_line())           # name, power limit
    t = time.perf_counter()
    lib, log = kernel.build()
    print(f"build: fleet_mlp {time.perf_counter() - t:.2f} s -> "
          f"{lib.relative_to(ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    rec = kernel_phase("cuda", time_it=True)
    path = path_phase("cuda")
    print(json.dumps({"kernels": [{
        "name": "fleet_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/fleet_mlp/csrc/fleet_mlp.cu",
        "replaces": "src/repro/kernels/fleet_mlp/kernel.py:34",
        "launches": path["launches"], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
