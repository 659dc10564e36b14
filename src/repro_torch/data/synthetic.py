"""Deterministic synthetic token/frame streams + ``TensorSpec`` input specs.

``input_specs_for(cfg, shape)`` is the single source of truth for what each
(arch x input-shape) cell feeds its step function; ``synthetic_batch_for``
materialises it. Every draw comes from numpy's generators exactly as the
JAX package's twin draws it, so both packages see the same tokens; only
the tensors' home differs (``device``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..arch.model import TensorSpec
from ..configs.base import ModelConfig, ShapeSpec
from ..kernels.common import resolve_device

VISION_FRACTION = 8          # vlm stub: first S/8 positions are patch embeds


def input_specs_for(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Model inputs for one cell (training batch or serving request batch)."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        if cfg.frontend == "frames":
            raise ValueError(f"{cfg.name} is encoder-only; no decode inputs")
        return {"tokens": TensorSpec((B, 1), torch.int32)}
    # train / prefill
    if cfg.frontend == "frames":
        specs = {"frames": TensorSpec((B, S, cfg.d_model), dt)}
    else:
        specs = {"tokens": TensorSpec((B, S), torch.int32)}
        if cfg.frontend == "patches":
            specs["vision_embeds"] = TensorSpec(
                (B, S // VISION_FRACTION, cfg.d_model), dt)
            if cfg.use_mrope:
                specs["positions"] = TensorSpec((3, B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = TensorSpec((B, S), torch.int32)
    return specs


def synthetic_batch_for(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                        device="cuda"):
    """Materialise a batch matching ``input_specs_for`` (smoke scale only)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in input_specs_for(cfg, shape).items():
        if spec.dtype == torch.int32:
            hi = cfg.vocab_size if name in ("tokens", "labels") else spec.shape[-1]
            a = rng.integers(0, max(hi, 2), size=spec.shape).astype(np.int32)
            out[name] = torch.from_numpy(a).to(device)
        else:
            a = rng.normal(0, 1, size=spec.shape).astype(np.float32)
            out[name] = torch.from_numpy(a).to(device=device, dtype=spec.dtype)
    return out


def synthetic_lm_batch(vocab: int, batch: int, seq: int, seed: int = 0,
                       device="cuda"):
    """Next-token-prediction batch from a deterministic mixing stream."""
    rng = np.random.default_rng(seed)
    # Zipf-ish marginal + short-range structure so a model can actually learn
    base = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    toks = torch.from_numpy(base.astype(np.int32)).to(resolve_device(device))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SyntheticTokenStream:
    """Host-sharded deterministic stream.

    Each host materialises only its slice of the global batch; ``__iter__``
    yields ready batches on ``device``. (Per-host slicing keys off
    ``host_index``; here the process count is 1.)
    """

    def __init__(self, vocab: int, global_batch: int, seq: int,
                 *, host_count: int = 1, host_index: int = 0, seed: int = 0,
                 device="cuda"):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.vocab, self.seq = vocab, seq
        self.local_batch = global_batch // host_count
        self.host_index = host_index
        self.seed = seed
        self.device = resolve_device(device)
        self.step = 0

    def next(self):
        b = synthetic_lm_batch(
            self.vocab, self.local_batch, self.seq,
            seed=hash((self.seed, self.host_index, self.step)) % (2**31),
            device=self.device)
        self.step += 1
        return b

    def __iter__(self):
        while True:
            yield self.next()
