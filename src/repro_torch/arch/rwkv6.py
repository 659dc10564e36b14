"""RWKV-6 (Finch) block: time-mix (WKV scan with data-dependent decay) +
channel-mix, both with token-shift. LayerNorms are handled by the caller
(model.py) like every other block; this module provides the two mixers.
Train/prefill go through the chunked WKV scan (``kernels/rwkv6_scan``: the
CUDA kernel on a card); decode through the plain one-token recurrence.

Decode state per layer: (x_prev_tm (B,d), x_prev_cm (B,d), wkv (B,H,K,K)).

Tensor parallelism: with ``tp`` (a ``distributed.sharding.TPContext``) the
mixers take one rank's shards of the ``model`` axis, read from the weights'
shapes. A time-mix whose ``u`` is shorter than the config's heads holds WKV
heads ``[r H/tp, (r+1) H/tp)``: ``wr``, ``wk``, ``wv`` and ``wg`` are their
column shards, ``u`` their rows and ``wo`` its row shard; ``w0``,
``w_lora_B`` and the group norm's ``ln_x_scale`` / ``ln_x_bias`` come whole
and the rank uses its heads' channels of them; the token shift, the
data-dependent lerp and the decay's ``w_lora_A`` run at full width on
every rank. ``wo``'s partial products are reduced on the way out, and the
``wkv`` state is the rank's heads. A channel-mix whose ``wk`` is narrower
than d_ff holds its columns, ``wv``'s rows and the receptance ``wr``'s
d-column shard: the partial ``kv`` is reduce-scattered onto the rank's d
columns, gated there, and the product all-gathered
(``TPContext.gate``). ``x_tm`` and ``x_cm`` stay whole. Without ``tp``, or
with whole weights, the mixers compute as without a mesh.
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


def _decay(p, xw, cols=None):
    """Data-dependent per-channel decay w in (0,1), in f32: at channels
    ``cols`` (a slice) where given."""
    lo = torch.tanh((xw @ p["w_lora_A"].to(xw.dtype)).to(torch.float32))
    w0, wb = p["w0"], p["w_lora_B"]
    if cols is not None:
        w0, wb = w0[cols], wb[:, cols]
    ww = w0.to(torch.float32) + lo @ wb.to(torch.float32)
    return torch.exp(-torch.exp(ww))               # (B,S,d) f32


def _rkvgw(p, x, dx, cols=None):
    """The time-mix projections: r, k, v, the gate g in x's dtype and the
    decay w in f32, each (B, S, d), or at channels ``cols`` of the decay
    where the projections are column shards."""
    xw, xk, xv, xr, xg = _ddlerp(p, x, dx)
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = F.silu((xg @ p["wg"].to(x.dtype)).to(torch.float32)).to(x.dtype)
    return r, k, v, g, _decay(p, xw, cols)


def wkv_head_range(cfg: ModelConfig, p, tp) -> tuple:
    """(first WKV head, heads) this rank holds of ``p["u"]``: all H where
    it is whole."""
    hl, H = p["u"].shape[0], cfg.rwkv_heads
    if hl == H:
        return 0, H
    if tp is None or hl * tp.tp != H:
        raise ValueError(f"{hl} of {H} WKV heads on a model axis of "
                         f"{getattr(tp, 'tp', 1)}")
    return tp.rank * hl, hl


def _heads(cfg, p, tp, x):
    """(x as the time-mix computes on it, the rank's heads, their channels
    as a slice or None where it holds every head)."""
    lo, hl = wkv_head_range(cfg, p, tp)
    sharded = hl < cfg.rwkv_heads
    if tp is not None:
        x = tp.enter(x, sharded)
    K = cfg.rwkv_head_size
    return x, hl, slice(lo * K, (lo + hl) * K) if sharded else None


def _out(cfg, p, tp, y, g, hl, cols):
    """The group norm on the rank's heads, the gate and ``wo`` (its partial
    products reduced over the model axis where the heads split)."""
    B, S = y.shape[:2]
    scale, bias = p["ln_x_scale"], p["ln_x_bias"]
    if cols is not None:
        scale, bias = scale[cols], bias[cols]
    y = _group_norm(scale, bias, y.reshape(B, S, -1), hl)
    out = (y * g) @ p["wo"].to(g.dtype)
    return tp.leave(out, cols is not None) if tp is not None else out


def timemix_block(cfg: ModelConfig, p, x, x_prev, wkv_state=None, *,
                  chunk: int = 32, tp=None):
    """x: (B,S,d) normed input. Returns (out, last_x (B,d), new_wkv_state).
    With ``tp`` (see the module's docstring) ``x`` and ``out`` are in the
    residual stream's layout and the state is this rank's heads."""
    x, hl, cols = _heads(cfg, p, tp, x)
    B, S, _ = x.shape
    r, k, v, g, w = _rkvgw(p, x, _shift(x, x_prev) - x, cols)
    hshape = (B, S, hl, cfg.rwkv_head_size)
    y, new_state = wkv6_scan(r.reshape(hshape), k.reshape(hshape),
                             v.reshape(hshape), w.reshape(hshape),
                             p["u"].to(torch.float32), wkv_state, chunk=chunk)
    return _out(cfg, p, tp, y, g, hl, cols), x[:, -1], new_state


def timemix_decode(cfg: ModelConfig, p, x, x_prev, wkv_state, *, tp=None):
    """One token: x (B,1,d). Returns (out (B,1,d), last_x, new_state); the
    state passed in is read, never written. With ``tp`` and this rank's
    head shards, the state holds its heads."""
    x, hl, cols = _heads(cfg, p, tp, x)
    B = x.shape[0]
    hshape = (B, hl, cfg.rwkv_head_size)
    r, k, v, g, w = _rkvgw(p, x, x_prev[:, None] - x, cols)
    y, new_state = wkv6_decode_step(
        wkv_state, r[:, 0].reshape(hshape), k[:, 0].reshape(hshape),
        v[:, 0].reshape(hshape), w[:, 0].reshape(hshape),
        p["u"].to(torch.float32))
    return _out(cfg, p, tp, y[:, None], g, hl, cols), x[:, 0], new_state


def channelmix_block(cfg: ModelConfig, p, x, x_prev, *, tp=None):
    """x: (B,S,d) normed input. Returns (out, last_x (B,d)). With ``tp``
    and this rank's column shards, ``x`` and ``out`` are in the residual
    stream's layout."""
    sharded = p["wk"].shape[-1] < cfg.d_ff
    if tp is not None:
        x = tp.enter(x, sharded)
    dx = _shift(x, x_prev) - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    k = torch.square(torch.clamp(k.to(torch.float32), min=0.0)).to(x.dtype)
    kv = k @ p["wv"].to(x.dtype)
    rgate = torch.sigmoid((xr @ p["wr"].to(x.dtype))
                          .to(torch.float32)).to(x.dtype)
    if sharded:
        return tp.gate(rgate, kv), x[:, -1]
    out = rgate * kv
    return tp.leave(out, False) if tp is not None else out, x[:, -1]
