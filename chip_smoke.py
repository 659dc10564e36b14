#!/usr/bin/env python3
"""Start the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit; the three kernels
   (``fleet_mlp``, ``flash_attention``, ``decode_attention``) are built
   from the sources in the checkout, one ``nvcc`` each, all started
   together (seconds and ``ptxas`` lines).
2. kernel: each kernel through its public op against its plain PyTorch
   version on the same inputs. ``fleet_mlp`` at the scoring shape (N=512,
   b=1, F=54, width 512, depth 5, f32), the unit-test shapes in f32 and
   bf16, and a ragged N=500. ``flash_attention`` at the qwen3-1.7b prefill
   shape (B 4, S 1024, H 16, KV 8, D 128, bf16, causal) and the test
   shapes in both dtypes (D 80, non-causal, Sq < Skv, ragged).
   ``decode_attention`` at the engine shape (B 8, S 2048, H 16, KV 8,
   D 128, bf16, seeded lengths) and the test shapes. Each path shape is
   timed with CUDA events beside its bound, the plain version's time and
   (for attention) ``scaled_dot_product_attention``'s.
3. fleet path: ``Castor.tick(executor="fleet")`` over a 512-prosumer site
   at the paper's ANN width (hidden 512), seeded versions, three hourly
   score ticks: every job ok, 24 ``fleet_mlp`` launches per score bin, the
   device rollout entered once per bin, ticks 2-3 on the warm runtime,
   finite forecasts and bands, and a few forecasts held against the plain
   per-instance scoring path.
4. prefill path: qwen3-1.7b at full width (28 layers, bf16 parameters
   from a seeded generator), ``forward(mode="prefill")`` on 4 prompts of
   1024 tokens: 28 ``flash_attention`` launches, finite logits, caches
   (28, 4, 1024, 8, 128); then one 128-token prompt's prefill logits held
   against ``decode_step`` fed the same tokens one at a time.
5. serve path: ``ServeEngine`` on the same parameters, 8 slots of 2048
   positions, 16 seeded requests (prompts of 16-96 tokens, 32 new tokens
   each, greedy): every request done, 28 ``decode_attention`` launches per
   engine decode call; tokens/s, step time, time to first token, peak
   device memory.

Every kernel count is set to 0 just before each path and read just after.
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
                           (1, 64, 256, 4, 2, 32), (2, 37, 200, 4, 1, 80)])]
# (label, B, S, H, KV, D, dtype); the first is the engine shape
DECODE_PATH_CASE = ("serve", 8, 2048, 16, 8, 128, "bfloat16")
DECODE_CASES = [DECODE_PATH_CASE] + [
    (f"test{i}", *s, dt) for dt in ("float32", "bfloat16")
    for i, s in enumerate([(3, 256, 4, 2, 32), (2, 128, 8, 8, 64),
                           (3, 200, 4, 4, 80), (2, 300, 28, 4, 128)])]
# prefill vs token-by-token decode of the same 128 tokens, relative L2 of
# the last logits: both run in bf16 but round in different places (GEMMs of
# 128 rows against 1, the caches written by prefill against by decode), a
# few bf16 ulps (2^-8 each) that 28 residual layers carry to the logits
PREFILL_DECODE_TOL = 5e-2

KERNEL_NAMES = ("fleet_mlp", "flash_attention", "decode_attention")
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


def reset_counts() -> None:
    """Every kernel's launch count to 0 (before each path)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fleet_mlp import ops as fleet
    for ops in (fleet, fa, dec):
        ops.reset_invocation_count()


def _agree(label, got, want, dtype) -> dict:
    """Error of ``got`` against ``want``; fails past ``ATTN_TOL``."""
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel gave {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - want.float()).abs()
    rel = float((diff / (1 + want.float().abs())).max())
    ok = rel <= ATTN_TOL[dtype] and bool(torch.isfinite(got.float()).all())
    print(f"{label} {dtype}: rel_err={rel:.3e} max_abs_err="
          f"{float(diff.max()):.3e} tol={ATTN_TOL[dtype]:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version: {rel:.3e} > "
              f"{ATTN_TOL[dtype]:.0e}")
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


def _timed(record: dict, kernel, plain, library, iters: int) -> None:
    """CUDA-event times, in turns: plain, kernel, library, kernel, plain."""
    plain_ms = [_time_ms(plain, max(1, iters // 4))]
    kern_ms = [_time_ms(kernel, iters)]
    lib_ms = _time_ms(library, iters)
    kern_ms.append(_time_ms(kernel, iters))
    plain_ms.append(_time_ms(plain, max(1, iters // 4)))
    record.update(ms=sum(kern_ms) / 2, plain_ms=sum(plain_ms) / 2,
                  library_ms=lib_ms)


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
        if label != FLASH_PATH_CASE[0]:
            continue
        record = {**rec, **flash_bound(q, k, causal)}
        if time_it:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            _timed(record,
                   lambda: flash_attention(q, k, v, causal=causal),
                   lambda: attention_reference(q, k, v, causal=causal),
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
            print(f"flash_attention prefill time: {record['ms']:.4f} "
                  f"ms/launch; bound {record['bound_ms']:.4f} ms by "
                  f"{record['bound_by']} ({record['bytes']} bytes, "
                  f"{record['flops']} flop); plain version "
                  f"{record['plain_ms']:.4f} ms; scaled_dot_product_attention "
                  f"{record['library_ms']:.4f} ms")
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
        if label != DECODE_PATH_CASE[0]:
            continue
        record = {**rec, **decode_bound(q, kc, lengths)}
        if time_it:
            qt = q[:, :, None]
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            mask = (torch.arange(S, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            _timed(record,
                   lambda: decode_attention(q, kc, vc, lengths),
                   lambda: decode_attention_reference(q, kc, vc, lengths),
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask, enable_gqa=True), 50)
            print(f"decode_attention engine time: {record['ms']:.4f} "
                  f"ms/launch; bound {record['bound_ms']:.4f} ms by "
                  f"{record['bound_by']} ({record['bytes']} bytes, "
                  f"{record['flops']} flop); plain version "
                  f"{record['plain_ms']:.4f} ms; scaled_dot_product_attention "
                  f"{record['library_ms']:.4f} ms")
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


def prefill_phase(device: str, cfg, params, *, batch: int = 4,
                  seq: int = 1024, check_len: int = 128,
                  seed: int = 12) -> dict:
    """``forward(mode="prefill")`` on seeded prompts, then the decode
    cross-check. Returns the path's record."""
    import torch
    from repro_torch.arch import model as M
    from repro_torch.kernels.flash_attention import ops as fa
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
    launches = fa.invocation_count()
    print(f"prefill: {batch} x {seq} tokens in {secs:.3f} s wall "
          f"({batch * seq / secs:.1f} tokens/s), flash_attention launches "
          f"{launches}")
    check(launches == cfg.num_layers,
          f"prefill: {launches} flash_attention launches for "
          f"{cfg.num_layers} layers")
    check(tuple(logits.shape) == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill: logits {tuple(logits.shape)} not finite / wrong shape")
    want = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
    for name in ("k", "v"):
        got = tuple(state["caches"]["pos0"][name].shape)
        check(got == want, f"prefill: {name} cache {got} != {want}")
    check(state["lengths"].tolist() == [seq] * batch,
          f"prefill: lengths {state['lengths'].tolist()}")
    del state

    # the same prompt through both kernels: prefill's last logits against
    # decode_step fed the tokens one at a time
    prompt = tokens[:1, :check_len]
    with torch.no_grad():
        pf_logits, _ = M.forward(cfg, params, {"tokens": prompt},
                                 mode="prefill")
        dstate = M.init_decode_state(cfg, 1, check_len, device=device)
        for i in range(check_len):
            dec_logits, dstate = M.decode_step(
                cfg, params, dstate, {"tokens": prompt[:, i:i + 1]})
    rel = float(torch.linalg.vector_norm(dec_logits - pf_logits)
                / torch.linalg.vector_norm(pf_logits))
    ok = rel <= PREFILL_DECODE_TOL
    print(f"prefill check: {check_len}-token prompt, prefill vs "
          f"token-by-token decode logits rel L2 {rel:.3e} (tol "
          f"{PREFILL_DECODE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"prefill and decode disagree: rel L2 {rel:.3e}")
    return {"seconds": secs, "launches": launches, "rel_l2": rel}


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
    from repro_torch.kernels.decode_attention import ops as dec
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
    launches = dec.invocation_count()
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
    print(f"serve: {done}/{n_requests} requests, {total} tokens out in "
          f"{secs:.3f} s ({rec['tokens_per_s']:.1f} tokens/s); "
          f"{eng.steps} engine steps (mean {rec['step_ms']:.2f} ms), "
          f"{eng.decode_calls} decode calls with admission (mean "
          f"{rec['decode_call_ms']:.2f} ms); time to first token median "
          f"{rec['ttft_median_s']:.3f} s, mean {rec['ttft_mean_s']:.3f} s, "
          f"max {rec['ttft_max_s']:.3f} s over {n_requests} requests; "
          f"decode_attention launches {launches}")
    if cuda:
        print(f"serve peak device memory: {rec['peak_bytes']} bytes "
              f"(torch.cuda.max_memory_allocated over the run)")
    print(f"serve cut: none ({n_requests} requests, {slots} slots x "
          f"{max_seq} positions)")
    check(done == n_requests, f"serve: {n_requests - done} requests not done")
    check(total == n_requests * new_tokens == eng.tokens_out,
          f"serve: {total} tokens out, {eng.tokens_out} counted")
    check(launches == cfg.num_layers * eng.decode_calls,
          f"serve: {launches} decode_attention launches for "
          f"{eng.decode_calls} decode calls x {cfg.num_layers} layers")
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


def build_all() -> None:
    """One ``nvcc`` per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fleet_mlp import kernel as fleet

    def timed(mod):
        t = time.perf_counter()
        lib, log = mod.build()
        return lib, log, time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        built = list(zip(KERNEL_NAMES, pool.map(timed, (fleet, fa, dec))))
    for name, (lib, log, secs) in built:
        print(f"build: {name} {secs:.2f} s -> {lib.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")
    print(f"build: all kernels in {time.perf_counter() - t:.2f} s")


def kernel_line(fleet_rec, fleet_path, flash_rec, prefill, dec_rec,
                serve) -> dict:
    rows = []
    for name, rec, launches, replaces in (
            ("fleet_mlp", fleet_rec, fleet_path["launches"],
             "src/repro/kernels/fleet_mlp/kernel.py:34"),
            ("flash_attention", flash_rec, prefill["launches"],
             "src/repro/kernels/flash_attention/kernel.py:65"),
            ("decode_attention", dec_rec, serve["launches"],
             "src/repro/kernels/decode_attention/kernel.py:53")):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")})
    return {"kernels": rows}


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

    fleet_rec = kernel_phase("cuda", time_it=True)
    flash_rec = flash_phase("cuda", time_it=True)
    dec_rec = decode_phase("cuda", time_it=True)
    fleet_path = path_phase("cuda")
    cfg, params = lm_params("qwen3-1.7b", "cuda")
    prefill = prefill_phase("cuda", cfg, params)
    serve = serve_phase("cuda", cfg, params)
    prof = profile_decode(serve["engine"])
    if prof["device_ms_per_call"] is not None:
        print(f"serve: device busy share "
              f"{prof['device_ms_per_call'] / serve['decode_call_ms']:.3f} "
              f"of a decode call (kernel time over the unprofiled mean)")
    print(f"smoke: {time.perf_counter() - t_all:.1f} s in all")
    print(json.dumps(kernel_line(fleet_rec, fleet_path, flash_rec, prefill,
                                 dec_rec, serve)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
