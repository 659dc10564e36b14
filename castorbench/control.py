"""The readings the check's limits are set from, on the card: for each
seed, a cell's set-up and a short window as a run makes them, then the
numbers the check compares for the program's answers and for the
control, the reference in TF32 put in the program's place. With
``--fault``, the program runs with that fault planted
(``harness/faults.py``). One JSON line a seed; the benchmark's own runs
never run this.

    python3 castorbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--fault state_unchanged|half_batch|answer_altered]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device: str, fault=None,
             control: bool = True) -> dict:
    """The program's numbers and, with ``control``, the control's, for
    one seed."""
    from castorbench.harness import check, driver, faults
    cfg = cell.config
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    t = time.perf_counter()
    with ctx:
        flow = driver.Flow(cell, seed, device)
        flow.setup()
        run = driver.Run(cell=cell, device=device,
                         sizes=driver.layer_sizes(cfg),
                         rows=cfg["train_window_days"] * 24
                         - cfg["target_lags"])
        driver.run_window(flow, run, seconds, False)
    out = check.gather(flow, run, seed)
    flow.castor = None
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.empty_cache()
    rec = {"seed": seed, "fault": fault, "ticks": len(run.ticks),
           "program": check.numbers(flow, out)}
    if out["losses"]:
        want = check.reference_losses(flow, out)
        rec["loss_steps"] = check.loss_gaps(
            [r["losses"] for r in out["losses"]], want)
        if control:
            rec["control_loss_steps"] = check.loss_gaps(
                check.reference_losses(flow, out, tf32=True), want)
    if control:
        rec["control"] = check.control_numbers(flow, out)
    rec["seconds"] = time.perf_counter() - t
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also read the control")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from castorbench.harness import cells
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 2
    cell = cells.find_cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = readings(cell, seed, args.seconds, "cuda", args.fault,
                       control=i < args.control_seeds and not args.fault)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
