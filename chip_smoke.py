#!/usr/bin/env python3
"""Start the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit; the five kernels
   (``fleet_mlp``, ``flash_attention``, ``decode_attention``,
   ``ssd_scan``, ``wkv6_scan``) are built from the sources in the
   checkout, one ``nvcc`` each, all started together (seconds and
   ``ptxas`` lines).
2. kernel: each kernel through its public op against its plain PyTorch
   version on the same inputs. ``fleet_mlp`` at the scoring shape (N=512,
   b=1, F=54, width 512, depth 5, f32), the unit-test shapes in f32 and
   bf16, and a ragged N=500. ``flash_attention`` at the qwen3-1.7b prefill
   shape (B 4, S 1024, H 16, KV 8, D 128, bf16, causal) and the test
   shapes in both dtypes (D 80, non-causal, Sq < Skv, ragged).
   ``decode_attention`` at the engine shape (B 8, S 2048, H 16, KV 8,
   D 128, bf16, seeded lengths) and the test shapes. Both attention
   kernels also at zamba2-2.7b's shapes (prefill B 4, S 1024, H = KV = 32,
   D 80, causal; engine B 4, S 512, group 1, D 80), timed there too.
   ``flash_attention`` runs its wgmma route on bf16 and its CUDA-core
   route on f32; ``decode_attention`` is two launches per call (split-KV
   partial pass and combine). ``ssd_scan`` at the
   zamba2-2.7b prefill shape (B 4, S 1024, H 80, P = N = 64, bf16) and
   ``wkv6_scan`` at the rwkv6-7b prefill shape (B 4, S 1024, H 64,
   K = V = 64, bf16, w in f32), both also at the unit-test shapes in f32
   and bf16 (``wkv6_scan`` at mild and aggressive decay), at strong decay
   (SSD, dt |A| up to 10) and extreme decay (WKV, w down to 1e-30) in both
   dtypes, outputs and final states. The scans run their tensor-core
   route on bf16 and their per-token route on f32 (each route's kernel,
   registers and shared memory printed at the build); the f32 route is
   also checked and timed at the path shape. Each path shape is timed
   with CUDA events beside its
   bound, the plain version's time and (for attention)
   ``scaled_dot_product_attention``'s, on rotating copies of its inputs
   that keep them cold in L2: eager calls (``ms``, the host's issue time
   where that is longer), and the kernel's and the library's calls
   replayed from a CUDA graph (device time).
3. fleet path: ``Castor.tick(executor="fleet")`` over a 512-prosumer site
   at the paper's ANN width (hidden 512), seeded versions, three hourly
   score ticks: every job ok, 24 ``fleet_mlp`` launches per score bin, the
   device rollout entered once per bin, ticks 2-3 on the warm runtime,
   finite forecasts and bands, and a few forecasts held against the plain
   per-instance scoring path.
4. prefill path: qwen3-1.7b at full width (28 layers, bf16 parameters
   from a seeded generator), ``forward(mode="prefill")`` on 4 prompts of
   1024 tokens: 28 ``flash_attention`` launches, finite logits, caches
   (28, 4, 1024, 8, 128), and the same forward timed again warm; then
   one 128-token prompt's prefill logits held against ``decode_step`` fed
   the same tokens one at a time.
5. serve path: ``ServeEngine`` on the same parameters, 8 slots of 2048
   positions, 16 seeded requests (prompts of 16-96 tokens, 32 new tokens
   each, greedy): every request done, 28 ``decode_attention`` launches per
   engine decode call; tokens/s, step time, time to first token, peak
   device memory; a profiler window of a few decode calls.
6. zamba2-2.7b at full width (54 Mamba2 blocks, the shared attention
   block once per 6-block period), as 4-5: prefill of 4 x 1024 tokens with
   54 ``ssd_scan`` and 9 ``flash_attention`` launches, a 128-token
   prompt's logits and final ``ssd`` states held against token-by-token
   decode, and ``ServeEngine`` with 4 slots x 512 positions and 8 requests
   (prompts 16-64, 16 new tokens): 9 ``decode_attention`` launches per
   decode call.
7. rwkv6-7b at full width (32 blocks), the same way: 32 ``wkv6_scan``
   launches per prefill, the ``wkv`` states held, the same engine run
   (its decode runs no kernel: the recurrences are plain, as in the
   reference).

Each model is freed before the next is drawn.
Every kernel count is set to 0 just before each path and read just after.
The last lines are the ``{"kernels": [...]}`` record and the device line.
Without a card, or without ``src/repro_torch`` beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import functools
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
# the card's L2 cache, which timed inputs must not stay in between calls
L2_BYTES = 50 * 2**20

# same tolerances as tests/test_torch_fleet_mlp.py, on |got - ref| / (1 + |ref|)
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# (label, N, b, F, hidden, depth, dtype); the first is the scoring shape
SCORING_CASE = ("scoring", 512, 1, 54, 512, 5, "float32")
TEST_SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1)]
KERNEL_CASES = [SCORING_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate(TEST_SHAPES)] + [
    ("ragged", 500, 1, 54, 512, 5, dt) for dt in ("float32", "bfloat16")]

# the tensor cores' dense bf16 rate (the attention kernels' inputs are
# bf16 on the path; their bound is the least time for the same work)
BF16_FLOP_PER_S = 989e12
# tests/test_kernels.py's tolerances for the attention kernels, on
# |got - ref| / (1 + |ref|): f32 sums in another order differ in the last
# digits, bf16 outputs keep ~3 significant digits
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (label, B, Sq, Skv, H, KV, D, dtype, causal); the first is the path shape
FLASH_PATH_CASE = ("prefill", 4, 1024, 1024, 16, 8, 128, "bfloat16", True)
FLASH_CASES = [FLASH_PATH_CASE] + [
    (f"test{i}", *s, dt, causal) for dt in ("float32", "bfloat16")
    for causal in (True, False)
    for i, s in enumerate([(1, 128, 128, 4, 4, 32), (2, 256, 256, 4, 2, 32),
                           (1, 128, 128, 8, 2, 64), (1, 96, 96, 4, 4, 80),
                           (1, 64, 256, 4, 2, 32), (2, 37, 200, 4, 1, 80)])] + [
    ("zamba2", 4, 1024, 1024, 32, 32, 80, "bfloat16", True)]
# the attention cases timed beside their plain version and SDPA: the path
# shapes (qwen3-1.7b's, in the kernels line) and zamba2-2.7b's
TIMED_LABELS = ("prefill", "serve", "zamba2")
# (label, B, S, H, KV, D, dtype); the first is the engine shape
DECODE_PATH_CASE = ("serve", 8, 2048, 16, 8, 128, "bfloat16")
DECODE_CASES = [DECODE_PATH_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(3, 256, 4, 2, 32), (2, 128, 8, 8, 64),
                           (3, 200, 4, 4, 80), (2, 300, 28, 4, 128)])] + [
    ("zamba2", 4, 512, 32, 32, 80, "bfloat16")]
# prefill vs token-by-token decode of the same 128 tokens, relative L2 of
# the last logits: both run in bf16 but round in different places (GEMMs of
# 128 rows against 1, the caches written by prefill against by decode), a
# few bf16 ulps (2^-8 each) that 28 residual layers carry to the logits
PREFILL_DECODE_TOL = 5e-2
# the same check for the recurrent families, on the last logits and on the
# final scan states (``ssd`` / ``wkv``, every layer). There the gap is
# larger: prefill rounds the conv / token-shift inputs and the scan's
# inputs over 128 rows, decode over one, and each flipped bf16 rounding is
# carried by the recurrence as well as by the residual stream. The same
# check at full depth on the CPU, at widths 256-1024 (bf16, 64 tokens),
# read 5.4e-2 to 7.7e-2 on the logits and 4.0e-2 to 7.5e-2 on the states
# for both families, flat in width; 1.5e-1 keeps a 2x margin over that. A
# scan that is wrong (a decay, a state carried wrongly) moves both by O(1);
# the kernels themselves are held to their plain versions far tighter
RECURRENT_DECODE_TOL = 1.5e-1

# tests/test_kernels.py's tolerances for the scans in f32 (per-token sums
# against chunked ones; WKV's decay products over up to 32 steps), on
# |got - ref| / (1 + |ref|); bf16 outputs keep ~3 significant digits. The
# final states are f32 on both sides and always take the f32 tolerance.
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
WKV_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# (label, B, S, H, P, N, dtype, chunk[, dt range]); the first is the
# zamba2-2.7b prefill shape, then tests/test_kernels.py's (dt ~ U(1e-3,
# 0.1), the default), then strong decay: dt ~ U(1, 5), so dt |A| reaches
# 10. The strong cases are held against the per-token recurrence
# (ssd_sequential): there the chunked plain form's f32 differences of
# large cumulative decays lose digits (1e-4 against a float64 recurrence)
SSD_PATH_CASE = ("prefill", 4, 1024, 80, 64, 64, "bfloat16", 64, (1e-3, 0.1))
SSD_CASES = [SSD_PATH_CASE] + [
    (f"test{i}", *s[:5], dt, s[5], (1e-3, 0.1)) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 16, 32), (1, 64, 2, 8, 32, 16),
                           (1, 96, 1, 32, 16, 32)])] + [
    (f"strong{i}", *s[:5], dt, s[5], (1.0, 5.0)) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 16, 32), (1, 256, 4, 64, 64, 64)])]
# (label, B, S, H, K, dtype, wmin, chunk); decays w ~ U(wmin, 0.999): 0.4
# is mild, 0.001 aggressive; below 1e-6 (extreme) w is log-uniform on
# [wmin, 0.999], so decays near 1e-30 occur, and the case is held against
# the per-token recurrence (wkv6_sequential), as the strong SSD cases
# are (the chunked form misses a float64 recurrence by 2e-3 there). The
# first is the rwkv6-7b prefill shape
WKV_PATH_CASE = ("prefill", 4, 1024, 64, 64, "bfloat16", 0.4, 32)
WKV_CASES = [WKV_PATH_CASE] + [
    (f"test{i}", *s[:4], dt, wmin, s[4]) for dt in ("float32", "bfloat16")
    for wmin in (0.4, 0.001)
    for i, s in enumerate([(2, 128, 3, 16, 32), (1, 64, 2, 32, 16)])] + [
    (f"extreme{i}", *s[:4], dt, 1e-30, s[4]) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(2, 128, 3, 16, 32), (1, 256, 4, 64, 32)])]

KERNEL_NAMES = ("fleet_mlp", "flash_attention", "decode_attention",
                "ssd_scan", "wkv6_scan")
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


def _input_sets(inputs: tuple, nbytes: int) -> list:
    """``inputs`` and as many clones as it takes for the other sets' bytes
    between two uses of one set to reach twice the card's L2: a call then
    finds its inputs cold, as it does on the path, where the other layers'
    weights and caches pass through the L2 between two calls."""
    n = 1 if nbytes >= 2 * L2_BYTES else 1 + -(-2 * L2_BYTES // nbytes)
    return [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]


def _time_ms(fn, sets: list, iters: int, graph: bool = False) -> float:
    """Mean milliseconds per call of ``fn(*sets[i % len(sets)])`` between
    CUDA events, after a warm-up. Eager, an op that the host issues more
    slowly than the card runs it reads the host's issue time; with
    ``graph`` the same calls are captured in one CUDA graph and replayed,
    and the time is the device's alone."""
    import torch
    calls = [functools.partial(fn, *sets[i % len(sets)])
             for i in range(iters)]
    for call in calls[:len(sets) + 2]:
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for call in calls:
                call()
        g.replay()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for call in calls:
            call()
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
        if time_it:
            _timed(record, _input_sets((x, ws, bs), record["bytes"]),
                   fleet_mlp, fleet_mlp_reference, None, 50)
            print("kernel scoring time: " + _times(
                record, "no single PyTorch call computes the per-instance "
                        "chain"))
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
    reset_counts()
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


def _kernel_ops() -> dict:
    """Each kernel's public op module, by name (each holds its count)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fleet_mlp import ops as fleet
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    return dict(zip(KERNEL_NAMES, (fleet, fa, dec, ssd, wkv)))


def reset_counts() -> None:
    """Every kernel's launch count to 0 (before each path)."""
    for ops in _kernel_ops().values():
        ops.reset_invocation_count()


def counts() -> dict:
    """Every kernel's launch count, by name."""
    return {name: ops.invocation_count()
            for name, ops in _kernel_ops().items()}


def _agree(label, got, want, dtype, tol=ATTN_TOL) -> dict:
    """Error of ``got`` against ``want``; fails past ``tol[dtype]``."""
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel gave {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - want.float()).abs()
    rel = float((diff / (1 + want.float().abs())).max())
    ok = rel <= tol[dtype] and bool(torch.isfinite(got.float()).all())
    print(f"{label} {dtype}: rel_err={rel:.3e} max_abs_err="
          f"{float(diff.max()):.3e} tol={tol[dtype]:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version: {rel:.3e} > "
              f"{tol[dtype]:.0e}")
    return {"max_abs_err": float(diff.max()), "rel_err": rel}


def _bound(flops: int, nbytes: int, flop_per_s: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_bound(q, k, causal: bool) -> dict:
    """q, k, v read once and the output written once over HBM, against the
    multiply-adds of the visible (query, key) pairs (2 D for q.k, 2 D for
    p.v) over the bf16 tensor-core rate."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    off = Skv - Sq
    pairs = sum(min(Skv, t + off + 1) for t in range(Sq)) if causal \
        else Sq * Skv
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    return _bound(B * H * pairs * 4 * D, nbytes, BF16_FLOP_PER_S)


def decode_bound(q, k_cache, lengths) -> dict:
    """q read and the output written once, plus the VALID cache entries of
    k and v (the kernel skips the rest), against 4 D operations per valid
    entry and query head over the bf16 tensor-core rate."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    valid = int(lengths.clamp(max=k_cache.shape[1]).sum())
    nbytes = (2 * q.numel() + 2 * valid * KV * D) * q.element_size() \
        + lengths.numel() * lengths.element_size()
    return _bound(valid * H * 4 * D, nbytes, BF16_FLOP_PER_S)


def _timed(record: dict, sets: list, kernel, plain, library,
           iters: int) -> None:
    """Times of ``kernel``, ``plain`` and ``library`` (None where no single
    PyTorch call computes the function), each called on the input sets in
    turn: eager in turns, plain, kernel, library, kernel, plain (``ms``,
    ``plain_ms``, ``library_ms``); then the kernel's and the library's
    calls replayed from a CUDA graph (``graph_ms``, ``library_graph_ms``)."""
    plain_ms = [_time_ms(plain, sets, max(1, iters // 4))]
    kern_ms = [_time_ms(kernel, sets, iters)]
    lib_ms = None if library is None else _time_ms(library, sets, iters)
    kern_ms.append(_time_ms(kernel, sets, iters))
    plain_ms.append(_time_ms(plain, sets, max(1, iters // 4)))
    record.update(
        ms=sum(kern_ms) / 2, plain_ms=sum(plain_ms) / 2, library_ms=lib_ms,
        graph_ms=_time_ms(kernel, sets, iters, graph=True),
        library_graph_ms=None if library is None
        else _time_ms(library, sets, iters, graph=True))


def _times(rec: dict, library: str) -> str:
    """The timing half of a kernel phase's print line."""
    lib = f"{library} {rec['library_ms']:.4f} ms (graph replay " \
          f"{rec['library_graph_ms']:.4f})" if rec["library_ms"] is not None \
        else f"library: none ({library})"
    return (f"{rec['ms']:.4f} ms/call eager, {rec['graph_ms']:.4f} ms by "
            f"CUDA graph replay, inputs cold in L2; bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({rec['bytes']} "
            f"bytes, {rec['flops']} flop); plain version "
            f"{rec['plain_ms']:.4f} ms; {lib}")


def flash_phase(device: str, cases=FLASH_CASES, *, time_it: bool) -> dict:
    """``flash_attention`` through its public op against the plain version
    for every case; returns the path case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_reference
    record = None
    for seed, (label, B, Sq, Skv, H, KV, D, dtype, causal) in \
            enumerate(cases):
        g = torch.Generator(device=device).manual_seed(100 + seed)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(B, s, n, D, generator=g, device=device).to(dt)
                   for s, n in ((Sq, H), (Skv, KV), (Skv, KV)))
        got = flash_attention(q, k, v, causal=causal)
        want = attention_reference(q, k, v, causal=causal)
        rec = _agree(f"flash_attention {label:7s} B={B} Sq={Sq} Skv={Skv} "
                     f"H={H} KV={KV} D={D} causal={causal}", got, want, dtype)
        if label not in TIMED_LABELS:
            continue
        rec.update(flash_bound(q, k, causal))
        if time_it:     # each set: q, k, v and SDPA's (B, H, S, D) views
            sets = [(*s, *(t.transpose(1, 2) for t in s))
                    for s in _input_sets((q, k, v), rec["bytes"])]
            _timed(rec, sets,
                   lambda q, k, v, *_: flash_attention(q, k, v,
                                                       causal=causal),
                   lambda q, k, v, *_: attention_reference(q, k, v,
                                                           causal=causal),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[3:], is_causal=causal, enable_gqa=True), 20)
            print(f"flash_attention {label} time: " + _times(
                rec, "scaled_dot_product_attention"))
        if label == FLASH_PATH_CASE[0]:
            record = rec
    return record


def decode_phase(device: str, cases=DECODE_CASES, *, time_it: bool) -> dict:
    """``decode_attention`` through its public op against the plain version
    for every case; returns the engine case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    record = None
    for seed, (label, B, S, H, KV, D, dtype) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(200 + seed)
        dt = getattr(torch, dtype)
        q = torch.randn(B, H, D, generator=g, device=device).to(dt)
        kc, vc = (torch.randn(B, S, KV, D, generator=g, device=device).to(dt)
                  for _ in range(2))
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=device,
                                dtype=torch.int32)
        got = decode_attention(q, kc, vc, lengths)
        want = decode_attention_reference(q, kc, vc, lengths)
        rec = _agree(f"decode_attention {label:5s} B={B} S={S} H={H} KV={KV} "
                     f"D={D} lengths={lengths.tolist() if B <= 8 else '...'}",
                     got, want, dtype)
        if label not in TIMED_LABELS:
            continue
        rec.update(decode_bound(q, kc, lengths))
        if time_it:     # each set: q, caches, lengths and SDPA's views
            mask = (torch.arange(S, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            sets = [(q, kc, vc, n, q[:, :, None], kc.transpose(1, 2),
                     vc.transpose(1, 2)) for q, kc, vc, n in
                    _input_sets((q, kc, vc, lengths), rec["bytes"])]
            _timed(rec, sets,
                   lambda *s: decode_attention(*s[:4]),
                   lambda *s: decode_attention_reference(*s[:4]),
                   lambda *s: F.scaled_dot_product_attention(
                       *s[4:], attn_mask=mask, enable_gqa=True), 50)
            print(f"decode_attention {label} time (partial + combine "
                  "launch): " + _times(rec, "scaled_dot_product_attention"))
        if label == DECODE_PATH_CASE[0]:
            record = rec
    return record


def ssd_bound(x, dt, Bm, D, chunk: int) -> dict:
    """x, dt, A, B, C, D read once, y and the final f32 state written once
    over HBM, against the chunked form's products per (batch row, chunk,
    head): C B^T and (C B^T o L)(dt x), 2 c^2 (N + P), and the chunk's
    state contribution and the state's read-out, 4 c P N; over the bf16
    tensor-core rate."""
    B, S, H, P = x.shape
    N = Bm.shape[3]
    c = min(chunk, S)
    io = (x, dt, Bm, Bm, D, D)                   # B and C, A and D alike
    nbytes = sum(t.numel() * t.element_size() for t in io) \
        + x.numel() * x.element_size() + B * H * P * N * 4
    flops = B * (S // c) * H * (2 * c * c * (N + P) + 4 * c * P * N)
    return _bound(flops, nbytes, BF16_FLOP_PER_S)


def wkv_bound(r, w, u, chunk: int) -> dict:
    """r, k, v (r's type), w and u read once, y and the final f32 state
    written once over HBM, against the chunked form's multiply-adds per
    (batch row, head, chunk): the decayed scores r k dec, 3 c^2 K, their
    product with v, 2 c^2 V, and the state's read-out and update,
    4 c K V; over the bf16 tensor-core rate."""
    B, S, H, K = r.shape
    V = K
    c = min(chunk, S)
    nbytes = 4 * r.numel() * r.element_size() \
        + (w.numel() + u.numel() + B * H * K * V) * 4
    flops = B * H * (S // c) * (3 * c * c * K + 2 * c * c * V + 4 * c * K * V)
    return _bound(flops, nbytes, BF16_FLOP_PER_S)


def _uniform(g, lo, hi, shape, device):
    import torch
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _decays(g, wmin, shape, device):
    """w ~ U(wmin, 0.999); log-uniform on [wmin, 0.999] below 1e-6."""
    import math
    import torch
    if wmin >= 1e-6:
        return _uniform(g, wmin, 0.999, shape, device)
    lo, hi = math.log(wmin), math.log(0.999)
    return torch.exp(_uniform(g, lo, hi, shape, device))


def _f32_route_times(record: dict, inputs: tuple, op) -> None:
    """The f32 route's eager and graph-replay times on copies of ``inputs``
    rotated cold in L2, as the bf16 route is timed (``f32_ms``,
    ``f32_graph_ms``)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    sets = _input_sets(inputs, nbytes)
    record.update(f32_ms=_time_ms(op, sets, 20),
                  f32_graph_ms=_time_ms(op, sets, 20, graph=True))


def ssd_phase(device: str, cases=SSD_CASES, *, time_it: bool) -> dict:
    """``ssd_scan`` through its public op against the plain chunked version
    for every case, output and final state; returns the path case's
    record. Inputs as tests/test_kernels.py draws them."""
    import torch
    from repro_torch.kernels.mamba2_scan.ops import ssd_scan
    from repro_torch.kernels.mamba2_scan.ref import ssd_chunked, ssd_sequential
    record = None
    for seed, (label, B, S, H, P, N, dtype, chunk, *dt_range) in \
            enumerate(cases):
        dt_range = dt_range[0] if dt_range else (1e-3, 0.1)
        g = torch.Generator(device=device).manual_seed(300 + seed)
        dt_ = getattr(torch, dtype)
        x = torch.randn(B, S, H, P, generator=g, device=device).to(dt_)
        dt = _uniform(g, *dt_range, (B, S, H), device)
        A = -_uniform(g, 0.5, 2.0, (H,), device)
        Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=device).to(dt_)
                  for _ in range(2))
        D = torch.randn(H, generator=g, device=device)
        y, st = ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
        want_y, want_st = ssd_sequential(x, dt, A, Bm, Cm, D) \
            if label.startswith("strong") \
            else ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk)
        name = f"ssd_scan {label:7s} B={B} S={S} H={H} P={P} N={N}"
        rec = _agree(name, y, want_y, dtype, SSD_TOL)
        _agree(name + " state", st, want_st, "float32", SSD_TOL)
        if label != SSD_PATH_CASE[0]:
            continue
        record = {**rec, **ssd_bound(x, dt, Bm, D, chunk)}
        if time_it:
            _timed(record,
                   _input_sets((x, dt, A, Bm, Cm, D), record["bytes"]),
                   lambda *a: ssd_scan(*a, chunk=chunk),
                   lambda *a: ssd_chunked(*a, chunk=chunk), None, 20)
            print("ssd_scan prefill time: " + _times(
                record, "no single PyTorch call computes the scan"))
            # the per-token route (the first design, which f32 still takes)
            # at the same shape, checked and timed on the same card
            f32 = (x.float(), dt, A, Bm.float(), Cm.float(), D)
            y32, st32 = ssd_scan(*f32, chunk=chunk)
            want32 = ssd_chunked(*f32, chunk=chunk)
            _agree(name + " f32 route", y32, want32[0], "float32", SSD_TOL)
            _agree(name + " f32 route state", st32, want32[1], "float32",
                   SSD_TOL)
            _f32_route_times(record, f32, lambda *a: ssd_scan(*a, chunk=chunk))
            print(f"ssd_scan prefill f32 route (per token, CUDA cores): "
                  f"{record['f32_ms']:.4f} ms/call eager, "
                  f"{record['f32_graph_ms']:.4f} ms by CUDA graph replay; "
                  f"the bf16 route is {record['f32_ms'] / record['ms']:.2f}x "
                  f"faster eager")
    return record


def wkv_phase(device: str, cases=WKV_CASES, *, time_it: bool) -> dict:
    """``wkv6_scan`` through its public op against the plain chunked
    version (exact masked decay) for every case, output and final state;
    returns the path case's record. w is f32 in every case, as on the
    path."""
    import torch
    from repro_torch.kernels.rwkv6_scan.ops import wkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential
    record = None
    for seed, (label, B, S, H, K, dtype, wmin, chunk) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(400 + seed)
        dt_ = getattr(torch, dtype)
        r, k, v = (torch.randn(B, S, H, K, generator=g, device=device).to(dt_)
                   for _ in range(3))
        w = _decays(g, wmin, (B, S, H, K), device)
        u = torch.randn(H, K, generator=g, device=device)
        y, st = wkv6_scan(r, k, v, w, u, chunk=chunk)
        want_y, want_st = wkv6_sequential(r, k, v, w, u) \
            if label.startswith("extreme") \
            else wkv6_chunked(r, k, v, w, u, chunk=chunk)
        name = (f"wkv6_scan {label:7s} B={B} S={S} H={H} K={K} "
                f"wmin={wmin}")
        rec = _agree(name, y, want_y, dtype, WKV_TOL)
        _agree(name + " state", st, want_st, "float32", WKV_TOL)
        if label != WKV_PATH_CASE[0]:
            continue
        record = {**rec, **wkv_bound(r, w, u, chunk)}
        if time_it:
            _timed(record,
                   _input_sets((r, k, v, w, u), record["bytes"]),
                   lambda *a: wkv6_scan(*a, chunk=chunk),
                   lambda *a: wkv6_chunked(*a, chunk=chunk), None, 20)
            print("wkv6_scan prefill time: " + _times(
                record, "no single PyTorch call computes the scan"))
            f32 = (r.float(), k.float(), v.float(), w, u)
            y32, st32 = wkv6_scan(*f32, chunk=chunk)
            want32 = wkv6_chunked(*f32, chunk=chunk)
            _agree(name + " f32 route", y32, want32[0], "float32", WKV_TOL)
            _agree(name + " f32 route state", st32, want32[1], "float32",
                   WKV_TOL)
            _f32_route_times(record, f32,
                             lambda *a: wkv6_scan(*a, chunk=chunk))
            print(f"wkv6_scan prefill f32 route (per token, CUDA cores): "
                  f"{record['f32_ms']:.4f} ms/call eager, "
                  f"{record['f32_graph_ms']:.4f} ms by CUDA graph replay; "
                  f"the bf16 route is {record['f32_ms'] / record['ms']:.2f}x "
                  f"faster eager")
    return record


def lm_params(arch: str, device: str, seed: int = 0):
    """The config and its parameters, drawn on the device from a seeded
    generator and stored in the config's compute dtype."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    t = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, g, dtype=cfg.dtype, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    print(f"lm setup: {cfg.name}, {M.param_count(cfg)} parameters in "
          f"{cfg.dtype}, drawn in {time.perf_counter() - t:.1f} s")
    return cfg, params


def forward_launches(cfg) -> dict:
    """Kernel launches of one ``forward``: one ``flash_attention`` per
    attention block and per application of the shared block, one scan per
    recurrent block, nothing else."""
    per = cfg.num_periods
    n = {name: 0 for name in KERNEL_NAMES}
    n["flash_attention"] = per * (cfg.pattern.count("attn")
                                  + int(cfg.shared_attn_every_period))
    n["ssd_scan"] = per * cfg.pattern.count("mamba2")
    n["wkv6_scan"] = per * cfg.pattern.count("rwkv6")
    return n


def _rel_l2(got, want) -> float:
    import torch
    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


def prefill_phase(device: str, cfg, params, *, batch: int = 4,
                  seq: int = 1024, check_len: int = 128,
                  seed: int = 12) -> dict:
    """``forward(mode="prefill")`` on seeded prompts, then the decode
    cross-check: the last logits and, for the recurrent families, the
    final scan states (``ssd`` / ``wkv`` of every layer). Returns the
    path's record."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.arch.params import tree_leaves
    cuda = device != "cpu"
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=device)

    reset_counts()
    t = time.perf_counter()
    with torch.no_grad():
        logits, state = M.forward(cfg, params, {"tokens": tokens},
                                  mode="prefill")
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = counts()
    print(f"prefill: {cfg.name} {batch} x {seq} tokens in {secs:.3f} s wall "
          f"({batch * seq / secs:.1f} tokens/s), launches " + ", ".join(
              f"{name} {n}" for name, n in launches.items() if n))
    want = forward_launches(cfg)
    check(launches == want,
          f"prefill: kernel launches {launches}, expected {want}")
    check(tuple(logits.shape) == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill: logits {tuple(logits.shape)} not finite / wrong shape")
    specs = tree_leaves(M.decode_state_specs(cfg, batch, seq)["caches"])
    for spec, got in zip(specs, tree_leaves(state["caches"]), strict=True):
        check(tuple(got.shape) == spec.shape and got.dtype == spec.dtype,
              f"prefill: cache {tuple(got.shape)} {got.dtype} != "
              f"{spec.shape} {spec.dtype}")
    check(state["lengths"].tolist() == [seq] * batch,
          f"prefill: lengths {state['lengths'].tolist()}")
    del state, logits
    # the same forward again, warm (allocator, cuBLAS and the kernel
    # libraries loaded): the wall that the kernels' speed moves
    t = time.perf_counter()
    with torch.no_grad():
        M.forward(cfg, params, {"tokens": tokens}, mode="prefill")
    if cuda:
        torch.cuda.synchronize()
    warm = time.perf_counter() - t
    print(f"prefill: {cfg.name} warm forward (the same prompts again) in "
          f"{warm:.3f} s wall ({batch * seq / warm:.1f} tokens/s)")

    # the same prompt through both paths: prefill's last logits (and final
    # scan states) against decode_step fed the tokens one at a time
    prompt = tokens[:1, :check_len]
    with torch.no_grad():
        pf_logits, pf_state = M.forward(cfg, params, {"tokens": prompt},
                                        mode="prefill")
        dstate = M.init_decode_state(cfg, 1, check_len, device=device)
        for i in range(check_len):
            dec_logits, dstate = M.decode_step(
                cfg, params, dstate, {"tokens": prompt[:, i:i + 1]})
    recurrent = [(key, n) for key, leaves in pf_state["caches"].items()
                 for n in leaves if n in ("ssd", "wkv")]
    tol = RECURRENT_DECODE_TOL if recurrent else PREFILL_DECODE_TOL
    rel = _rel_l2(dec_logits, pf_logits)
    ok = rel <= tol
    print(f"prefill check: {check_len}-token prompt, prefill vs "
          f"token-by-token decode logits rel L2 {rel:.3e} (tol {tol:.1e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"prefill and decode disagree: rel L2 {rel:.3e}")
    rec = {"seconds": secs, "warm_seconds": warm, "launches": launches,
           "rel_l2": rel, "tol": tol}
    if recurrent:
        cat = lambda st: torch.cat([st["caches"][key][n].flatten()  # noqa: E731
                                    for key, n in recurrent])
        rec["state_rel_l2"] = _rel_l2(cat(dstate), cat(pf_state))
        ok = rec["state_rel_l2"] <= tol
        names = sorted({n for _, n in recurrent})
        print(f"prefill check: final {'/'.join(names)} states of "
              f"{len(recurrent) * cfg.num_periods} layers, prefill vs decode "
              f"rel L2 {rec['state_rel_l2']:.3e} (tol {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"prefill and decode states disagree: rel L2 "
                  f"{rec['state_rel_l2']:.3e}")
    return rec


def serve_phase(device: str, cfg, params, *, slots: int = 8,
                max_seq: int = 2048, n_requests: int = 16,
                prompt_lens=(16, 96), new_tokens: int = 32,
                seed: int = 13) -> dict:
    """``ServeEngine`` over seeded requests until idle, stepped as
    ``run_until_idle`` steps it. A request's time to first token runs from
    its arrival to the end of the engine step that emitted the token (the
    engine stamps the step's start, before that step's admission prefill).
    Returns the path's record."""
    import numpy as np
    import torch
    from repro_torch.serve import Request, ServeEngine
    cuda = device != "cpu"
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(prompt_lens[0],
                                                    prompt_lens[1] + 1)))
                .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n_requests)]
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.arrived_at = t0
        eng.submit(r)
    first = {}
    total = 0
    with torch.no_grad():
        for _ in range(10_000):
            got = eng.step()
            t = time.perf_counter()    # the step read its tokens to the host
            for r in reqs:
                if r.first_token_at is not None and r.rid not in first:
                    first[r.rid] = t
            if got == 0 and not eng.queue:
                break
            total += got
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()
    done = sum(r.done for r in reqs)
    check(len(first) == n_requests, "serve: a request emitted no token")
    ttft = [first[r.rid] - r.arrived_at for r in reqs]
    rec = {"seconds": secs, "launches": launches, "requests": done,
           "tokens": total, "engine_steps": eng.steps,
           "decode_calls": eng.decode_calls,
           "tokens_per_s": total / secs,
           "step_ms": secs / eng.steps * 1e3,
           "decode_call_ms": secs / eng.decode_calls * 1e3,
           "ttft_median_s": float(np.median(ttft)),
           "ttft_mean_s": float(np.mean(ttft)),
           "ttft_max_s": float(np.max(ttft)),
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "engine": eng}
    print(f"serve: {cfg.name} {done}/{n_requests} requests, {total} tokens out in "
          f"{secs:.3f} s ({rec['tokens_per_s']:.1f} tokens/s); "
          f"{eng.steps} engine steps (mean {rec['step_ms']:.2f} ms), "
          f"{eng.decode_calls} decode calls with admission (mean "
          f"{rec['decode_call_ms']:.2f} ms); time to first token median "
          f"{rec['ttft_median_s']:.3f} s, mean {rec['ttft_mean_s']:.3f} s, "
          f"max {rec['ttft_max_s']:.3f} s over {n_requests} requests; "
          f"decode_attention launches {launches['decode_attention']}")
    if cuda:
        print(f"serve peak device memory: {rec['peak_bytes']} bytes "
              f"(torch.cuda.max_memory_allocated over the run)")
    print(f"serve cut: none ({n_requests} requests, {slots} slots x "
          f"{max_seq} positions)")
    check(done == n_requests, f"serve: {n_requests - done} requests not done")
    check(total == n_requests * new_tokens == eng.tokens_out,
          f"serve: {total} tokens out, {eng.tokens_out} counted")
    # decode runs one decode_attention per attention application and no
    # other kernel (the recurrences decode through their plain versions)
    per_call = forward_launches(cfg)["flash_attention"]
    want = {name: 0 for name in KERNEL_NAMES}
    want["decode_attention"] = per_call * eng.decode_calls
    check(launches == want,
          f"serve: kernel launches {launches} for {eng.decode_calls} decode "
          f"calls x {per_call} attention applications, expected {want}")
    check(all(len(r.tokens) == new_tokens and
              all(0 <= t < cfg.vocab_size for t in r.tokens) for r in reqs),
          "serve: a request's tokens are out of range or short")
    return rec


def profile_decode(eng, calls: int = 3, top: int = 6) -> dict:
    """``torch.profiler`` over a few engine decode calls with every slot
    advancing (after the served run): the device's kernel time per call and
    the kernels that take most of it. The kernel time over the call's
    unprofiled wall time is the device's busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = list(range(eng.max_slots))
    toks = np.ones((eng.max_slots, 1), np.int64)
    cuda = eng.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with torch.no_grad():
        eng._decode(toks, rows)
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                eng._decode(toks, rows)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
    kern = sorted(((e.key, e.device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in kern)
    print(f"serve profile: {calls} decode calls, {wall / calls * 1e3:.2f} "
          f"ms/call under the profiler, device kernel time "
          + (f"{dev_ms:.3f} ms/call" if kern else "not measured (the "
             "profiler saw no device activity)"))
    for name, ms in kern[:top]:
        print(f"serve profile: {ms:.4f} ms/call {name[:90]}")
    return {"device_ms_per_call": dev_ms if kern else None,
            "top": kern[:top]}


def _card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip()


def _ptxas_table(log: str) -> dict:
    """``ptxas -v`` output as {mangled entry function: (registers, spill
    store bytes, static shared memory bytes)}."""
    import re
    table, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            table[name] = (int(m.group(1)), spill,
                           int(smem.group(1)) if smem else 0)
    return table


def scan_routes(name: str, mod, log: str) -> None:
    """Print each route of a scan kernel: the dtype, the kernel function it
    launches, its registers, spills and shared memory (the bf16 route's
    16-byte-load instantiation, which the path shapes take)."""
    import torch
    table = _ptxas_table(log)
    for dtype, route in mod.ROUTES.items():
        fn = route.split()[0]
        tc = dtype == torch.bfloat16
        hits = [v for k, v in table.items()
                if fn + ("ILb1E" if tc else "I") in k]
        check(len(hits) == 1, f"build: {fn} not found once in ptxas output")
        regs, spill, smem = hits[0]
        mem = (f"{mod.TC_SMEM_BYTES} B dynamic shared memory a block, "
               f"{mod.blocks_per_sm()} blocks an SM") if tc else \
            f"{smem} B static shared memory a block"
        print(f"build: {name} route {str(dtype)[6:]} -> {route}: {regs} "
              f"registers, {spill} B spilled, {mem}")


def build_all() -> None:
    """One ``nvcc`` per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fleet_mlp import kernel as fleet
    from repro_torch.kernels.mamba2_scan import kernel as ssd
    from repro_torch.kernels.rwkv6_scan import kernel as wkv
    mods = (fleet, fa, dec, ssd, wkv)

    def timed(mod):
        t = time.perf_counter()
        lib, log = mod.build()
        return lib, log, time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(zip(KERNEL_NAMES, pool.map(timed, mods)))
    for name, (lib, log, secs) in built:
        print(f"build: {name} {secs:.2f} s -> {lib.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")
            elif "Compiling entry function" in line:
                print(f"build: {line.strip().split(chr(39))[1][:110]}")
    print(f"build: all kernels in {time.perf_counter() - t:.2f} s")
    logs = {name: log for name, (_, log, _) in built}
    for name, mod in (("ssd_scan", ssd), ("wkv6_scan", wkv)):
        scan_routes(name, mod, logs[name])
    import torch
    for D in (128, 80):
        print(f"build: dynamic shared memory per block at D {D}: "
              f"flash_attention bf16 {fa.smem_bytes(D, torch.bfloat16)} B, "
              f"f32 {fa.smem_bytes(D, torch.float32)} B; decode_attention "
              f"(group 2) bf16 {dec.smem_bytes(2, D, torch.bfloat16)} B, "
              f"f32 {dec.smem_bytes(2, D, torch.float32)} B")


# where each kernel's TPU twin is defined (file:line of the function that
# reaches pl.pallas_call)
REPLACES = {
    "fleet_mlp": "src/repro/kernels/fleet_mlp/kernel.py:34",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:65",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:53",
    "ssd_scan": "src/repro/kernels/mamba2_scan/kernel.py:63",
    "wkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:60",
}
# the package directory of each kernel under src/repro_torch/kernels
PACKAGE = {"ssd_scan": "mamba2_scan", "wkv6_scan": "rwkv6_scan"}


def kernel_line(records: dict, launches: dict) -> dict:
    """The ``{"kernels": [...]}`` record: for each kernel its timed path
    case (``records``) and its launches on its main path (``launches``)."""
    rows = []
    for name in KERNEL_NAMES:
        rec = records[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{PACKAGE.get(name, name)}/"
                      f"csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            **{key: rec.get(key) for key in
               ("library_ms", "graph_ms", "library_graph_ms", "f32_ms",
                "f32_graph_ms")}})
    return {"kernels": rows}


def lm_path(arch: str, device: str, *, profile: bool = True,
            serve_kw=None) -> dict:
    """One language model's prefill and serve paths (and a profiler window
    over its engine); the model is freed before returning. Returns the
    prefill and serve records (the serve record without its engine)."""
    import torch
    cfg, params = lm_params(arch, device)
    prefill = prefill_phase(device, cfg, params)
    serve = serve_phase(device, cfg, params, **(serve_kw or {}))
    eng = serve.pop("engine")
    if profile:
        prof = profile_decode(eng)
        if prof["device_ms_per_call"] is not None:
            print(f"serve: {cfg.name} device busy share "
                  f"{prof['device_ms_per_call'] / serve['decode_call_ms']:.3f}"
                  f" of a decode call (kernel time over the unprofiled mean)")
    del eng, params
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"cfg": cfg, "prefill": prefill, "serve": serve}


# the recurrent families' engine runs: 4 slots x 512 positions, 8 requests
RECURRENT_SERVE = dict(slots=4, max_seq=512, n_requests=8,
                       prompt_lens=(16, 64), new_tokens=16)


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
    t_all = time.perf_counter()
    print(_card_line())           # name, power limit
    build_all()

    records = {"fleet_mlp": kernel_phase("cuda", time_it=True),
               "flash_attention": flash_phase("cuda", time_it=True),
               "decode_attention": decode_phase("cuda", time_it=True),
               "ssd_scan": ssd_phase("cuda", time_it=True),
               "wkv6_scan": wkv_phase("cuda", time_it=True)}
    fleet_path = path_phase("cuda")
    qwen = lm_path("qwen3-1.7b", "cuda")
    zamba = lm_path("zamba2-2.7b", "cuda", serve_kw=RECURRENT_SERVE)
    rwkv = lm_path("rwkv6-7b", "cuda", serve_kw=RECURRENT_SERVE)
    # each kernel's launches on the path of the slice that ported it
    launches = {"fleet_mlp": fleet_path["launches"],
                "flash_attention": qwen["prefill"]["launches"]["flash_attention"],
                "decode_attention": qwen["serve"]["launches"]["decode_attention"],
                "ssd_scan": zamba["prefill"]["launches"]["ssd_scan"],
                "wkv6_scan": rwkv["prefill"]["launches"]["wkv6_scan"]}
    print(f"smoke: {time.perf_counter() - t_all:.1f} s in all")
    print(json.dumps(kernel_line(records, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
