"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> selective SSD scan
-> gated RMSNorm -> out_proj. Train/prefill go through the chunked SSD scan
(``kernels/mamba2_scan``: the CUDA kernel on a card); decode carries
(conv_state, ssd_state) through the plain one-token recurrence.

Tensor parallelism: with ``tp`` (a ``distributed.sharding.TPContext``) and
``A_log`` shorter than the config's heads, the block takes one rank's
shards of the ``model`` axis, read from the weights' shapes: the rank owns
SSD heads ``[r H/tp, (r+1) H/tp)``, and ``A_log``, ``D``, ``dt_bias``,
``norm_scale`` and ``out_proj``'s rows are its heads' shards. Of the fused
``[z, x, B, C, dt]`` projection it needs its heads' ``z``, ``x`` and
``dt`` columns and the whole ``B`` and ``C`` (one group: every head reads
them). In train and prefill ``in_proj`` comes whole (gathered with its
period) and the rank multiplies by those columns alone; a decode step
takes this rank's column shard (or the whole weight), multiplies by it
and gathers the projected token over ``model``. ``conv_w`` and ``conv_b``
come whole. The gated RMSNorm's mean runs over all d_inner channels: each
rank's sum of squares is summed over ``model`` (``TPContext.total``), and
``out_proj``'s partial products are reduced on the way out. The ``ssd`` state is this rank's heads; the
``conv`` state is whole on every rank. Without ``tp``, or with whole
weights, the block computes as without a mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba2_scan.ops import ssd_scan
from ..kernels.mamba2_scan.ref import ssd_decode_step
from ..distributed.sharding import gather
from .params import ParamSpec

_G = 1  # ssm groups (ngroups=1 for all assigned archs)


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    conv_ch = di + 2 * _G * N                 # conv runs over [x, B, C]
    proj = 2 * di + 2 * _G * N + H            # [z, x, B, C, dt]
    return di, H, N, conv_ch, proj


def mamba2_specs(cfg: ModelConfig):
    d = cfg.d_model
    di, H, N, conv_ch, proj = _dims(cfg)
    return {
        "in_proj": ParamSpec((d, proj), ("embed", "mamba_proj")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "ssm_inner"), "uniform_small", 0.5),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), "ssm_A"),
        "D": ParamSpec((H,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "ssm_dt"),
        "norm_scale": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg, zxbcdt):
    di, H, N, _, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, _G * N, _G * N, H], dim=-1)


def _gated_rmsnorm(scale, y, z, eps=1e-5, tp=None, width: int = 0):
    """With ``tp``: ``y``, ``z`` and ``scale`` are this rank's channels of
    ``width``, and the mean of the squares is over all of them."""
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if tp is None:
        ms = torch.mean(torch.square(yf), -1, keepdim=True)
    else:
        ms = tp.total(torch.sum(torch.square(yf), -1, keepdim=True)) / width
    return (yf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(y.dtype)


def _dt_and_A(p, dt):
    """dt = softplus(dt + dt_bias) and A = -exp(A_log), both in f32."""
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, -torch.exp(p["A_log"].to(torch.float32))


def ssd_head_range(cfg: ModelConfig, p, tp) -> tuple:
    """(first SSD head, heads) this rank holds of ``p["A_log"]``: all H
    where it is whole."""
    hl, H = p["A_log"].shape[-1], cfg.ssm_heads
    if hl == H:
        return 0, H
    if tp is None or hl * tp.tp != H:
        raise ValueError(f"{hl} of {H} SSD heads on a model axis of "
                         f"{getattr(tp, 'tp', 1)}")
    return tp.rank * hl, hl


def _own(cfg, lo: int, hl: int, device) -> tuple:
    """Indices of the rank's columns of the fused projection ([its z, its
    x, B, C, its dt]) and of its conv channels ([its x, B, C])."""
    di, _, N, _, _ = _dims(cfg)
    P = cfg.ssm_head_dim
    a, b = lo * P, (lo + hl) * P
    ar = lambda s, e: torch.arange(s, e, device=device)       # noqa: E731
    cols = torch.cat([ar(a, b), ar(di + a, di + b),
                      ar(2 * di, 2 * di + 2 * _G * N),
                      ar(2 * di + 2 * _G * N + lo,
                         2 * di + 2 * _G * N + lo + hl)])
    chans = torch.cat([ar(a, b), ar(di, di + 2 * _G * N)])
    return cols, chans


def mamba2_block(cfg: ModelConfig, p, x, init_state=None, *, chunk: int = 64,
                 tp=None, cache: bool = True):
    """x: (B, S, d). Returns (out (B,S,d), (conv_state, ssd_state)): the
    conv state is the PRE-activation tail of [x, B, C], the last
    ``ssm_conv - 1`` positions. With ``tp`` (see the module's docstring)
    ``x`` and ``out`` are in the residual stream's layout, the ssd state
    is this rank's heads, and the conv state is computed only where
    ``cache`` (else None)."""
    lo, hl = ssd_head_range(cfg, p, tp)
    if tp is not None:
        x = tp.enter(x, hl < cfg.ssm_heads)
    if hl < cfg.ssm_heads:
        return _block_on_heads(cfg, p, x, init_state, chunk, tp, cache,
                               lo, hl)
    B, S, _ = x.shape
    di, H, N, conv_ch, _ = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)

    # causal depthwise conv over [x, B, C]
    xbc = torch.cat([xs, Bm, Cm], -1)                             # (B,S,conv_ch)
    cw = p["conv_w"].to(x.dtype)                                  # (w, conv_ch)
    pad = F.pad(xbc, (0, 0, cfg.ssm_conv - 1, 0))
    conv = sum(pad[:, i:i + S] * cw[i][None, None]
               for i in range(cfg.ssm_conv))
    conv = F.silu((conv + p["conv_b"].to(x.dtype)).to(torch.float32)).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [di, _G * N, _G * N], dim=-1)

    dt, A = _dt_and_A(p, dt)
    # the kernel takes contiguous tensors: the split views are copied once
    y, ssd_state = ssd_scan(xs.reshape(B, S, H, cfg.ssm_head_dim).contiguous(),
                            dt, A,
                            Bm.reshape(B, S, _G, N).contiguous(),
                            Cm.reshape(B, S, _G, N).contiguous(),
                            p["D"].to(torch.float32),
                            init_state, chunk=chunk)
    y = y.reshape(B, S, di)
    y = _gated_rmsnorm(p["norm_scale"], y, z)
    out = y @ p["out_proj"].to(x.dtype)
    if tp is not None:
        out = tp.leave(out, False)
    conv_state = xbc[:, S - (cfg.ssm_conv - 1):]                  # pre-activation tail
    return out, (conv_state, ssd_state)


def _block_on_heads(cfg, p, x, init_state, chunk, tp, cache, lo, hl):
    """``mamba2_block`` on this rank's SSD heads ``[lo, lo + hl)`` with
    ``in_proj`` whole; ``x`` whole along the sequence."""
    B, S, _ = x.shape
    di, _, N, conv_ch, _ = _dims(cfg)
    P, w = cfg.ssm_head_dim, cfg.ssm_conv
    cols, chans = _own(cfg, lo, hl, x.device)
    own = x @ p["in_proj"].index_select(1, cols).to(x.dtype)
    z, xs, Bm, Cm, dt = torch.split(own, [hl * P, hl * P, _G * N, _G * N,
                                          hl], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], -1)                       # (B,S,hl P + 2N)
    cw = p["conv_w"].index_select(1, chans).to(x.dtype)
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(pad[:, i:i + S] * cw[i][None, None] for i in range(w))
    conv = F.silu((conv + p["conv_b"].index_select(0, chans).to(x.dtype))
                  .to(torch.float32)).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [hl * P, _G * N, _G * N], dim=-1)
    dt, A = _dt_and_A(p, dt)
    y, ssd_state = ssd_scan(xs.reshape(B, S, hl, P).contiguous(), dt, A,
                            Bm.reshape(B, S, _G, N).contiguous(),
                            Cm.reshape(B, S, _G, N).contiguous(),
                            p["D"].to(torch.float32), init_state, chunk=chunk)
    y = _gated_rmsnorm(p["norm_scale"], y.reshape(B, S, hl * P), z, tp=tp,
                       width=di)
    out = tp.leave(y @ p["out_proj"].to(x.dtype), True)
    # every channel's pre-activation tail, alike on every rank: the tail's
    # tokens by the weight's [x, B, C] columns
    conv_state = x[:, S - (w - 1):] @ p["in_proj"][:, di:di + conv_ch] \
        .to(x.dtype) if cache else None
    return out, (conv_state, ssd_state)


def mamba2_decode(cfg: ModelConfig, p, x, state, *, tp=None):
    """One token. x: (B, 1, d); state = (conv_state (B,w-1,conv_ch),
    ssd_state (B,H,P,N)). Returns (out (B,1,d), new_state); the state
    passed in is read, never written. With ``tp`` and this rank's head
    shards, ``ssd_state`` holds its heads and the conv state is whole."""
    B = x.shape[0]
    di, H, N, conv_ch, _ = _dims(cfg)
    lo, hl = ssd_head_range(cfg, p, tp)
    sharded = hl < H
    if tp is not None:
        x = tp.enter(x, sharded)
    conv_state, ssd_state = state
    w = p["in_proj"]
    zxbcdt = x @ w.to(x.dtype)
    if w.shape[-1] < _dims(cfg)[4]:          # the projection gathered whole
        zxbcdt = gather(zxbcdt, 2, tp.model, tp.tp)
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)

    xbc = torch.cat([xs, Bm, Cm], -1)[:, 0]                       # (B,conv_ch)
    win = torch.cat([conv_state, xbc[:, None]], 1)                # (B,w,conv_ch)
    cw, cb = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if sharded:      # this rank's channels of the whole window
        P = cfg.ssm_head_dim
        chans = _own(cfg, lo, hl, x.device)[1]
        cw, cb = cw.index_select(1, chans), cb.index_select(0, chans)
        conv = torch.einsum("bwc,wc->bc", win.index_select(2, chans), cw) + cb
        z = z[..., lo * P:(lo + hl) * P]
        dt = dt[..., lo:lo + hl]
        width = hl * P
    else:
        conv = torch.einsum("bwc,wc->bc", win, cw) + cb
        width = di
    conv = F.silu(conv.to(torch.float32)).to(x.dtype)
    xs1, Bm1, Cm1 = torch.split(conv, [width, _G * N, _G * N], dim=-1)

    dt1, A = _dt_and_A(p, dt[:, 0])
    y, new_ssd = ssd_decode_step(
        ssd_state, xs1.reshape(B, hl, cfg.ssm_head_dim), dt1, A,
        Bm1.reshape(B, _G, N), Cm1.reshape(B, _G, N),
        p["D"].to(torch.float32))
    y = _gated_rmsnorm(p["norm_scale"], y.reshape(B, 1, width), z,
                       tp=tp if sharded else None, width=di)
    out = y @ p["out_proj"].to(x.dtype)
    if tp is not None:
        out = tp.leave(out, sharded)
    return out, (win[:, 1:], new_ssd)
