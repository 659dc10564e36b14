"""Training driver: supervised loop with async checkpointing,
restart-on-failure and (optional) a simulated node failure.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 50
    python -m repro_torch.launch.train --smoke --steps 2 --device cpu

Parameters are f32 masters drawn by ``init_params`` from a seeded
``torch.Generator`` on the device; the forward computes in the config's
dtype. Checkpoints go under ``--checkpoint-dir`` (``artifacts/ckpt``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..arch import model as M
from ..configs import get_config
from ..data.synthetic import SyntheticTokenStream
from ..distributed.checkpoint import CheckpointManager
from ..distributed.fault import NodeFailure, TrainSupervisor
from ..kernels.common import resolve_device
from ..train import AdamWConfig, init_state, make_train_step


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a node failure at this step (test fault path)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def run(argv=None):
    """The launcher's whole run; returns (losses, final state {"params",
    "opt"}, the supervisor's report, the checkpoint manager)."""
    args = _parser().parse_args(argv)
    arch = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(arch)
    device = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params~{M.param_count(cfg)/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={device}")

    g = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, g, device=device)
    opt = AdamWConfig(lr=args.lr)
    opt_state = init_state(params, opt)
    step_fn = make_train_step(cfg, opt=opt)
    stream = SyntheticTokenStream(cfg.vocab_size, args.batch, args.seq,
                                  device=device)

    ckpt = CheckpointManager(f"{args.checkpoint_dir}/{cfg.name}", keep=3)
    state = {"params": params, "opt": opt_state}
    start = 0
    if args.resume:
        restored, manifest = ckpt.restore_latest(state)
        if restored is not None:
            state, start = restored, manifest["step"]
            print(f"[train] resumed from step {start}")

    losses = []
    fail_at = {"n": args.inject_failure_at}

    def supervised_step(st, batch):
        if fail_at["n"] == len(losses):
            fail_at["n"] = -1
            raise NodeFailure("injected failure (--inject-failure-at)")
        p, o, metrics = step_fn(st["params"], st["opt"], batch)
        losses.append(float(metrics["loss"]))
        return {"params": p, "opt": o}

    sup = TrainSupervisor(ckpt, checkpoint_every=args.checkpoint_every)
    t0 = time.time()
    state, rep = sup.run(state, iter(stream), supervised_step,
                         start_step=start, num_steps=args.steps)
    dt = time.time() - t0
    tok_s = rep.steps_run * args.batch * args.seq / max(dt, 1e-9)
    print(f"[train] ran {rep.steps_run} steps in {dt:.1f}s "
          f"({tok_s:,.0f} tok/s) failures={rep.failures_handled} "
          f"restores={rep.restores}")
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"[train] loss first10={np.mean(losses[:k]):.4f} "
              f"last10={np.mean(losses[-k:]):.4f}")
    ckpt.save_sync(state, step=rep.final_step)
    print(f"[train] final checkpoint at step {rep.final_step}")
    return losses, state, rep, ckpt


def main(argv=None):
    return run(argv)[0]


if __name__ == "__main__":
    main()
