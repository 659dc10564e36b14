"""Runs one cell of the benchmark of the PyTorch and CUDA port
(``src/repro_torch``) on the card, and prints its result as the last line
of standard output.

    python3 castorbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, its traffic mix and the readers of its
metrics are found by name (``BENCHMARK.json``, ``castorbench/configs``,
``traffic``, ``workloads``, ``metrics``). Set-up builds the seed's site and
the fleet and warms the cell's shapes; the window then drives
``Castor.tick`` for ``--seconds``; with ``--trace 1`` the profiler records
the card and the per-layer metrics are reported instead of the end-to-end
ones. Once the window has closed, the program's answers are held to the
plain reference (``castorbench/reference``), each number compared printed
beside its limit on standard error and in the result's ``checks``.

Exits with 2, printing no result, without a card (or with fewer than the
cell asks for), and with 3 if any module of JAX or of the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the benchmark measures the port alone: none of these may be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: one thread per math library: the host's share of a run is the
#: program's own Python and numpy, and idle pool threads only add noise
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Set-up, the window and the check of one run; the result line's
    object, with ``checks`` last."""
    from castorbench.harness import cells, check, driver
    from castorbench.harness import trace as trace_mod
    cfg = cell.config
    t_flow = time.perf_counter()
    flow = driver.Flow(cell, seed, device)
    flow.setup()
    laps = [("imports and card", t_flow - t_start)] + [
        (label, t - t_prev) for (_, t_prev), (label, t)
        in zip(flow.laps[:-1], flow.laps[1:])]
    print("set-up laps (s): " + ", ".join(f"{k} {v:.3f}" for k, v in laps),
          file=sys.stderr)
    run = driver.Run(cell=cell, device=device, sizes=driver.layer_sizes(cfg),
                     rows=cfg["train_window_days"] * 24 - cfg["target_lags"])
    run.setup_s = time.perf_counter() - t_start
    driver.run_window(flow, run, seconds, trace)
    secs = sorted(t.seconds for t in run.ticks)
    print(f"window: {len(secs)} ticks, tick s min {secs[0]:.4f} median "
          f"{secs[len(secs) // 2]:.4f} max {secs[-1]:.4f}; first "
          f"{run.ticks[0].seconds:.4f} last {run.ticks[-1].seconds:.4f}",
          file=sys.stderr)
    metrics = cells.metric_values(
        run, cell.per_layer if trace else cell.end_to_end)
    out = check.gather(flow, run, seed)
    flow.castor = None
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.empty_cache()
    verdict = check.judge(check.numbers(flow, out), cell.params["limits"])
    failed = sum(t.failed for t in run.ticks)
    result = {"correct": verdict["correct"] and failed == 0,
              "attempted": run.attempted, "failed": failed,
              "metrics": metrics, "device": device_info(run, device)}
    if trace and run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(run)
    result["checks"] = verdict["checks"]
    return result


def device_info(run, device: str) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k in THREADS:
        os.environ[k] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from castorbench.harness import cells
    cell = cells.find_cell(args.workload)
    import torch
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"error: {args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"error: modules of {bad} were loaded", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
