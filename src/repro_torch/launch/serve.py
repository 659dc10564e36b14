"""Serving launcher: continuous-batching engine over synthetic request traffic.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --requests 12
    python -m repro_torch.launch.serve --smoke --device cpu

Parameters are drawn by ``init_params`` from a seeded ``torch.Generator`` on
the device and stored in the config's compute dtype (bf16 for the published
configs), so no step re-casts the weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..arch import model as M
from ..configs import get_config
from ..kernels.common import resolve_device
from ..serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(arch)
    device = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} slots={args.slots} max_seq={args.max_seq} "
          f"device={device}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, dtype=cfg.dtype, device=device)

    eng = ServeEngine(cfg, params, max_slots=args.slots, max_seq=args.max_seq)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len)
                    .astype(np.int32),
                    max_new_tokens=args.new_tokens, arrived_at=0.0)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    total = eng.run_until_idle()
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    print(f"[serve] {done}/{len(reqs)} requests, {total} tokens in {dt:.1f}s "
          f"({total/max(dt,1e-9):.1f} tok/s, {eng.steps} engine steps)")
    if done != len(reqs):
        raise RuntimeError(f"{len(reqs) - done} requests did not finish")
    return reqs


if __name__ == "__main__":
    main()
