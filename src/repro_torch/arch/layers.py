"""Shared transformer layers: norms, RoPE / M-RoPE, GQA attention, MLPs.

All functions are plain functions on tensors; parameters come in as nested
dicts built by the matching ``*_specs`` builders. Compute dtype follows the
inputs (bf16), accumulation and softmax in f32 inside the attention
kernels. Every cast below is a rounding point of the reference and is kept.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention.distributed import decode_attention_distributed
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .params import ParamSpec

# ---------------------------------------------------------------- norms

def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones"),
                "bias": ParamSpec((d,), ("embed",), "zeros")}
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, correction=0)   # population
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = torch.mean(torch.square(xf), -1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3): x (..., D), scale (D,)."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)

# ---------------------------------------------------------------- RoPE

def mrope_sections(head_dim: int):
    """Half-dim split for Qwen2-VL M-RoPE (t/h/w). 128 -> (16, 24, 24)."""
    half = head_dim // 2
    a = half // 4
    b = (half - a) // 2
    return (a, b, half - a - b)


def _freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def _rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim//2)."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float, *, mrope: bool = False):
    """x: (B, S, H, D); positions: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the half-dim frequency spectrum is PARTITIONED into
    (temporal, height, width) sections; each section keeps its slice of the
    full spectrum but rotates by its own position stream. The rotation pairs
    the two halves of the head dim (not interleaved pairs).
    """
    D = x.shape[-1]
    half = D // 2
    if mrope:
        freqs = _freqs(half, theta, x.device)
        parts_c, parts_s = [], []
        off = 0
        for i, sec in enumerate(mrope_sections(D)):
            ang = positions[i].to(torch.float32)[..., None] * freqs[off:off + sec]
            parts_c.append(torch.cos(ang))
            parts_s.append(torch.sin(ang))
            off += sec
        cos = torch.cat(parts_c, -1)
        sin = torch.cat(parts_s, -1)
    else:
        cos, sin = _rope_angles(positions, D, theta)
    cos = cos[:, :, None, :]                         # (B,S,1,half)
    sin = sin[:, :, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)

# ---------------------------------------------------------------- attention

def attention_specs(cfg: ModelConfig, d_in: Optional[int] = None):
    """Projections are stored FUSED over (H*hd), as in the reference; the
    head structure is recovered by a reshape inside the layer."""
    d = d_in or cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, cfg.d_model), ("heads", "embed")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), (None,), "ones")
        sp["k_norm"] = ParamSpec((hd,), (None,), "ones")
    if cfg.norm == "layernorm":                      # bias-ful archs
        sp["bq"] = ParamSpec((H * hd,), ("heads",), "zeros")
        sp["bk"] = ParamSpec((KV * hd,), ("kv_heads",), "zeros")
        sp["bv"] = ParamSpec((KV * hd,), ("kv_heads",), "zeros")
        sp["bo"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return sp


def _project_qkv(cfg, p, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def attention_block(cfg: ModelConfig, p, x, positions):
    """Full-sequence attention (train / prefill).

    x: (B, S, d_in) normed input. Returns (out (B,S,d_model), (k, v)) so
    prefill can populate caches.
    """
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta, mrope=cfg.use_mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope=cfg.use_mrope)
    o = flash_attention(q, k, v, causal=cfg.causal)
    B, S = o.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out, (k, v)


def attention_decode(cfg: ModelConfig, p, x, kstack, vstack, layer, lengths,
                     dist=None, rows=None):
    """One-token decode against STACKED caches (periods, B, S, KV, hd).

    Writes the new k/v IN PLACE at (layer, b, lengths[b]) — for every row,
    or only for the batch rows in ``rows`` (an index tensor) — then attends
    over lengths+1. The stacks are mutated, never copied. Returns
    (out (B,1,d_model), kstack, vstack).

    With ``dist`` ({"mesh": a DeviceMesh, optional "seq_axis" (default
    "model") and "batch_axes" (default ("data",))}) the stacks are this
    rank's S-chunk (periods, B, S_loc, KV, hd) of a cache sharded over the
    ranks of ``seq_axis``: only the rank whose chunk holds position
    ``lengths[b]`` writes the new k/v, at ``lengths[b] − offset`` in its
    chunk, and every rank attends over lengths+1 through the distributed
    flash-decode (``kernels/decode_attention/distributed.py``).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)                # (B,1,H/KV,hd)
    pos = lengths[:, None]                           # (B,1)
    if cfg.use_mrope:
        pos3 = lengths[None, :, None].expand(3, B, 1)
        q = apply_rope(q, pos3, cfg.rope_theta, mrope=True)
        k = apply_rope(k, pos3, cfg.rope_theta, mrope=True)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    b_idx = torch.arange(B, device=x.device) if rows is None else rows
    at = lengths.long()[b_idx]
    if dist is None:
        kstack[layer, b_idx, at] = k[b_idx, 0].to(kstack.dtype)
        vstack[layer, b_idx, at] = v[b_idx, 0].to(vstack.dtype)
        o = decode_attention(q[:, 0], kstack[layer], vstack[layer],
                             lengths + 1)
    else:
        seq_axis = dist.get("seq_axis", "model")
        S_loc = kstack.shape[2]
        at = at - dist["mesh"].get_local_rank(seq_axis) * S_loc
        # a row whose position lies in another rank's chunk rewrites the
        # slot it reads, so no rank waits on the host for a mask
        mine = ((at >= 0) & (at < S_loc))[:, None, None]
        at = at.clamp(0, S_loc - 1)
        for stack, new in ((kstack, k), (vstack, v)):
            stack[layer, b_idx, at] = torch.where(
                mine, new[b_idx, 0].to(stack.dtype), stack[layer, b_idx, at])
        o = decode_attention_distributed(
            q[:, 0], kstack[layer], vstack[layer], lengths + 1,
            mesh=dist["mesh"], seq_axis=seq_axis,
            batch_axes=dist.get("batch_axes", ("data",)))
    out = o.reshape(B, -1) @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out[:, None], kstack, vstack

# ---------------------------------------------------------------- MLP

def mlp_specs(cfg: ModelConfig, d_in: Optional[int] = None):
    d = d_in or cfg.d_model
    ff = cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": ParamSpec((d, ff), ("embed", "mlp")),
                "w_up": ParamSpec((d, ff), ("embed", "mlp")),
                "w_down": ParamSpec((ff, cfg.d_model), ("mlp", "embed"))}
    sp = {"w_in": ParamSpec((d, ff), ("embed", "mlp")),
          "w_down": ParamSpec((ff, cfg.d_model), ("mlp", "embed"))}
    if cfg.norm == "layernorm":
        sp["b_in"] = ParamSpec((ff,), ("mlp",), "zeros")
        sp["b_down"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return sp


def mlp_block(cfg: ModelConfig, p, x):
    if cfg.act == "swiglu":
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = x @ p["w_in"].to(x.dtype)
        if "b_in" in p:
            h = h + p["b_in"].to(x.dtype)
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    out = h @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        out = out + p["b_down"].to(x.dtype)
    return out
