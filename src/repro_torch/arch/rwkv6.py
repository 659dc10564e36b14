"""RWKV-6 (Finch) block: time-mix (WKV scan with data-dependent decay) +
channel-mix, both with token-shift. LayerNorms are handled by the caller
(model.py) like every other block; this module provides the two mixers.
Train/prefill go through the chunked WKV scan (``kernels/rwkv6_scan``: the
CUDA kernel on a card); decode through the plain one-token recurrence.

Decode state per layer: (x_prev_tm (B,d), x_prev_cm (B,d), wkv (B,H,K,K)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6_scan.ops import wkv6_scan
from ..kernels.rwkv6_scan.ref import wkv6_decode_step
from .params import ParamSpec

_DDLERP_R = 32      # low-rank dim of the data-dependent token-shift lerp
_DECAY_R = 64       # low-rank dim of the decay projection


def timemix_specs(cfg: ModelConfig):
    d = cfg.d_model
    H, K = cfg.rwkv_heads, cfg.rwkv_head_size
    return {
        "mu_x": ParamSpec((d,), ("embed",), "uniform_small", 1.0),
        "mu_5": ParamSpec((5, d), (None, "embed"), "uniform_small", 1.0),
        "lora_A": ParamSpec((d, 5 * _DDLERP_R), ("embed", None), "normal", 0.01),
        "lora_B": ParamSpec((5, _DDLERP_R, d), (None, None, "embed"), "normal", 0.01),
        "w0": ParamSpec((d,), ("embed",), "rwkv_decay"),
        "w_lora_A": ParamSpec((d, _DECAY_R), ("embed", None), "normal", 0.01),
        "w_lora_B": ParamSpec((_DECAY_R, d), (None, "embed"), "normal", 0.01),
        "u": ParamSpec((H, K), ("rwkv_heads", None), "uniform_small", 1.0),
        "wr": ParamSpec((d, d), ("embed", "rwkv_hidden")),
        "wk": ParamSpec((d, d), ("embed", "rwkv_hidden")),
        "wv": ParamSpec((d, d), ("embed", "rwkv_hidden")),
        "wg": ParamSpec((d, d), ("embed", "rwkv_hidden")),
        "wo": ParamSpec((d, d), ("rwkv_hidden", "embed")),
        "ln_x_scale": ParamSpec((d,), ("embed",), "ones"),
        "ln_x_bias": ParamSpec((d,), ("embed",), "zeros"),
    }


def channelmix_specs(cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), "uniform_small", 1.0),
        "mu_r": ParamSpec((d,), ("embed",), "uniform_small", 1.0),
        "wk": ParamSpec((d, ff), ("embed", "mlp")),
        "wv": ParamSpec((ff, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "rwkv_hidden")),
    }


def _shift(x, x_prev):
    """Token shift: x[t-1] with x_prev filling t=0. x: (B,S,d), x_prev: (B,d)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _group_norm(scale, bias, x, H, eps=1e-5):
    """Per-head LayerNorm over each head's channels. x: (B,S,d)."""
    B, S, d = x.shape
    xf = x.to(torch.float32).reshape(B, S, H, d // H)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)          # population
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def _ddlerp(p, x, dx):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    xxx = x + dx * p["mu_x"].to(x.dtype)
    s = torch.tanh((xxx @ p["lora_A"].to(x.dtype))
                   .to(torch.float32)).to(x.dtype)
    B, S, _ = x.shape
    s = s.reshape(B, S, 5, _DDLERP_R)
    off = torch.einsum("bsfr,frd->bsfd", s, p["lora_B"].to(x.dtype))
    mixed = (x[:, :, None] + dx[:, :, None]
             * (p["mu_5"].to(x.dtype)[None, None] + off))
    return [mixed[:, :, i] for i in range(5)]     # w,k,v,r,g


def _decay(p, xw):
    """Data-dependent per-channel decay w in (0,1), in f32."""
    lo = torch.tanh((xw @ p["w_lora_A"].to(xw.dtype)).to(torch.float32))
    ww = p["w0"].to(torch.float32) + lo @ p["w_lora_B"].to(torch.float32)
    return torch.exp(-torch.exp(ww))               # (B,S,d) f32


def _rkvgw(p, x, dx):
    """The time-mix projections: r, k, v, the gate g in x's dtype and the
    decay w in f32, each (B, S, d)."""
    xw, xk, xv, xr, xg = _ddlerp(p, x, dx)
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = F.silu((xg @ p["wg"].to(x.dtype)).to(torch.float32)).to(x.dtype)
    return r, k, v, g, _decay(p, xw)


def timemix_block(cfg: ModelConfig, p, x, x_prev, wkv_state=None, *,
                  chunk: int = 32):
    """x: (B,S,d) normed input. Returns (out, last_x (B,d), new_wkv_state)."""
    B, S, d = x.shape
    H, K = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, w = _rkvgw(p, x, _shift(x, x_prev) - x)
    hshape = (B, S, H, K)
    y, new_state = wkv6_scan(r.reshape(hshape), k.reshape(hshape),
                             v.reshape(hshape), w.reshape(hshape),
                             p["u"].to(torch.float32), wkv_state, chunk=chunk)
    y = _group_norm(p["ln_x_scale"], p["ln_x_bias"], y.reshape(B, S, d), H)
    out = (y * g) @ p["wo"].to(x.dtype)
    return out, x[:, -1], new_state


def timemix_decode(cfg: ModelConfig, p, x, x_prev, wkv_state):
    """One token: x (B,1,d). Returns (out (B,1,d), last_x, new_state); the
    state passed in is read, never written."""
    B, _, d = x.shape
    H, K = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, w = _rkvgw(p, x, x_prev[:, None] - x)
    y, new_state = wkv6_decode_step(
        wkv_state, r[:, 0].reshape(B, H, K), k[:, 0].reshape(B, H, K),
        v[:, 0].reshape(B, H, K), w[:, 0].reshape(B, H, K),
        p["u"].to(torch.float32))
    y = _group_norm(p["ln_x_scale"], p["ln_x_bias"], y.reshape(B, 1, d), H)
    out = (y * g) @ p["wo"].to(x.dtype)
    return out, x[:, 0], new_state


def channelmix_block(cfg: ModelConfig, p, x, x_prev):
    """x: (B,S,d) normed input. Returns (out, last_x (B,d))."""
    dx = _shift(x, x_prev) - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    k = torch.square(torch.clamp(k.to(torch.float32), min=0.0)).to(x.dtype)
    kv = k @ p["wv"].to(x.dtype)
    rgate = torch.sigmoid((xr @ p["wr"].to(x.dtype))
                          .to(torch.float32)).to(x.dtype)
    return rgate * kv, x[:, -1]
