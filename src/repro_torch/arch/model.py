"""LM builder for the pure-attention architectures: the PyTorch twin of the
reference's one scan-over-superblocks code path, with the scan written out
as a Python loop over the stacked period leaves.

Public surface:
    build_param_specs(cfg)            ParamSpec tree (init & counting)
    init_params(cfg, generator, ...)  materialised params on a device
    forward(cfg, params, batch, ...)  logits (train/prefill) or hidden
    decode_state_specs(cfg, B, S)     TensorSpec tree of the decode state
    init_decode_state(cfg, B, S, ...) zeroed decode state on a device
    decode_step(cfg, params, state, batch)  (logits, state)
    param_count(cfg)                  exact parameter count

Block kinds other than ``attn`` (``attn_moe``, ``mamba2``, ``rwkv6``) and
the Zamba2 shared block raise ``NotImplementedError`` naming the slice of
ROADMAP.md that ports them. Training (``chunked_ce``, ``train_loss``)
waits for the training slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from . import layers
from .params import (ParamSpec, init_tree, param_count as _spec_count,
                     stack_specs, tree_map)

_SLICE_OF = {
    "attn_moe": "the MoE slice",
    "mamba2": "the Zamba2 slice",
    "rwkv6": "the RWKV6 slice",
}


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} comes with "
                f"{_SLICE_OF.get(kind, 'a later slice')} (ROADMAP.md Queue 1)")
    if cfg.shared_attn_every_period:
        raise NotImplementedError(
            f"{cfg.name}: the weight-shared attention block comes with the "
            "Zamba2 slice (ROADMAP.md Queue 1)")


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ------------------------------------------------------------------ specs

def _block_specs(cfg: ModelConfig):
    return {"ln1": layers.norm_specs(cfg), "attn": layers.attention_specs(cfg),
            "ln2": layers.norm_specs(cfg), "mlp": layers.mlp_specs(cfg)}


def build_param_specs(cfg: ModelConfig):
    _check_supported(cfg)
    period = {f"pos{i}": _block_specs(cfg) for i in range(cfg.period_len)}
    specs = {"blocks": stack_specs(period, cfg.num_periods),
             "final_norm": layers.norm_specs(cfg)}
    if cfg.frontend != "frames":
        specs["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), "embed")
    if not (cfg.tie_embeddings and cfg.frontend != "frames"):
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), "normal")
    return specs


def param_count(cfg: ModelConfig) -> int:
    return _spec_count(build_param_specs(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Parameters drawn from ``generator`` (which lies on ``device``) with
    the reference's init laws, stored in ``dtype``."""
    return init_tree(build_param_specs(cfg), generator, _dtype(dtype),
                     resolve_device(device))


# ------------------------------------------------------------------ embed

def _embed(cfg: ModelConfig, params, batch, dtype):
    if cfg.frontend == "frames":
        return batch["frames"].to(dtype)
    # gather, then cast: the same values as casting the table first
    h = params["embed"][batch["tokens"]].to(dtype)
    if cfg.frontend == "patches" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(dtype)
        h = torch.cat([ve, h[:, ve.shape[1]:]], dim=1)
    return h


def _positions(cfg: ModelConfig, batch, B, S, device):
    if cfg.use_mrope:
        if "positions" in batch:
            return batch["positions"]
        base = torch.arange(S, device=device)[None].expand(B, S)
        return torch.stack([base] * 3)
    return torch.arange(S, device=device)[None].expand(B, S)


def _unembed(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings and "embed" in params:
        w = params["embed"].to(h.dtype).T
    else:
        w = params["lm_head"].to(h.dtype)
    return h @ w


def _period(blocks, i: int):
    """Period ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda t: t[i], blocks)


# ------------------------------------------------------------------ forward

def _apply_block(cfg, p, h, positions):
    """Full-sequence ``attn`` block. Returns (h, cache)."""
    a, (k, v) = layers.attention_block(cfg, p["attn"],
                                       layers.apply_norm(cfg, p["ln1"], h),
                                       positions)
    h = h + a
    h = h + layers.mlp_block(cfg, p["mlp"],
                             layers.apply_norm(cfg, p["ln2"], h))
    return h, {"k": k, "v": v}


def forward(cfg: ModelConfig, params, batch, *, mode: str = "train"):
    """Full-sequence forward. mode: "train" -> (logits (B,S,V) f32, {});
    "prefill" -> (last-token logits (B,V) f32, decode_state with caches
    (periods, B, S, KV, hd)); "hidden" -> (final hidden states, {})."""
    _check_supported(cfg)
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    dtype = _dtype(cfg.dtype)
    if cfg.frontend == "frames":
        B, S = batch["frames"].shape[:2]
        device = batch["frames"].device
    else:
        B, S = batch["tokens"].shape
        device = batch["tokens"].device
    h = _embed(cfg, params, batch, dtype)
    positions = _positions(cfg, batch, B, S, device)

    want_cache = mode == "prefill"
    per_period = []
    for i in range(cfg.num_periods):
        p = _period(params["blocks"], i)
        caches = {}
        for j in range(cfg.period_len):
            h, cache = _apply_block(cfg, p[f"pos{j}"], h, positions)
            if want_cache:
                caches[f"pos{j}"] = cache
        per_period.append(caches)

    h = layers.apply_norm(cfg, params["final_norm"], h)
    if mode == "hidden":
        return h, {}
    if mode == "train":
        return _unembed(cfg, params, h).to(torch.float32), {}
    # prefill: logits for the last position + populated decode state
    logits = _unembed(cfg, params, h[:, -1]).to(torch.float32)
    caches = {key: {n: torch.stack([c[key][n] for c in per_period])
                    for n in ("k", "v")}
              for key in per_period[0]}
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    return logits, {"caches": caches, "lengths": lengths}


# ------------------------------------------------------------------ decode

def decode_state_specs(cfg: ModelConfig, B: int, S: int, dtype=None):
    _check_supported(cfg)
    dtype = _dtype(dtype or cfg.dtype)
    shape = (cfg.num_periods, B, S, cfg.num_kv_heads, cfg.head_dim)
    caches = {f"pos{i}": {"k": TensorSpec(shape, dtype),
                          "v": TensorSpec(shape, dtype)}
              for i in range(cfg.period_len)}
    return {"caches": caches, "lengths": TensorSpec((B,), torch.int32)}


def init_decode_state(cfg: ModelConfig, B: int, S: int, dtype=None,
                      device="cuda"):
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    decode_state_specs(cfg, B, S, dtype))


def decode_step(cfg: ModelConfig, params, state, batch, *, rows=None):
    """One-token decode. batch: {"tokens": (B,1)} (or {"frames": (B,1,d)}).

    The stacked caches in ``state`` are updated IN PLACE: each layer writes
    the new k/v at ``lengths`` for every row, or only for the batch rows in
    ``rows`` (an index tensor), so rows outside it keep their caches
    exactly. Returns (logits (B,V) f32, {"caches": the same caches,
    "lengths": lengths + 1}).
    """
    if not cfg.is_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    _check_supported(cfg)
    dtype = _dtype(cfg.dtype)
    lengths = state["lengths"]
    caches = state["caches"]
    h = _embed(cfg, params, batch, dtype)
    for layer in range(cfg.num_periods):
        p = _period(params["blocks"], layer)
        for j in range(cfg.period_len):
            pj, cs = p[f"pos{j}"], caches[f"pos{j}"]
            a, _, _ = layers.attention_decode(
                cfg, pj["attn"], layers.apply_norm(cfg, pj["ln1"], h),
                cs["k"], cs["v"], layer, lengths, rows=rows)
            h = h + a
            h = h + layers.mlp_block(cfg, pj["mlp"],
                                     layers.apply_norm(cfg, pj["ln2"], h))
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = _unembed(cfg, params, h[:, 0]).to(torch.float32)
    return logits, {"caches": caches, "lengths": lengths + 1}
