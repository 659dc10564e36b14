"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> selective SSD scan
-> gated RMSNorm -> out_proj. Train/prefill go through the chunked SSD scan
(``kernels/mamba2_scan``: the CUDA kernel on a card); decode carries
(conv_state, ssd_state) through the plain one-token recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba2_scan.ops import ssd_scan
from ..kernels.mamba2_scan.ref import ssd_decode_step
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


def _gated_rmsnorm(scale, y, z, eps=1e-5):
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    ms = torch.mean(torch.square(yf), -1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(y.dtype)


def _dt_and_A(p, dt):
    """dt = softplus(dt + dt_bias) and A = -exp(A_log), both in f32."""
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, -torch.exp(p["A_log"].to(torch.float32))


def mamba2_block(cfg: ModelConfig, p, x, init_state=None, *, chunk: int = 64):
    """x: (B, S, d). Returns (out (B,S,d), (conv_state, ssd_state)): the
    conv state is the PRE-activation tail of [x, B, C], the last
    ``ssm_conv - 1`` positions."""
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
    conv_state = xbc[:, S - (cfg.ssm_conv - 1):]                  # pre-activation tail
    return out, (conv_state, ssd_state)


def mamba2_decode(cfg: ModelConfig, p, x, state):
    """One token. x: (B, 1, d); state = (conv_state (B,w-1,conv_ch),
    ssd_state (B,H,P,N)). Returns (out (B,1,d), new_state); the state
    passed in is read, never written."""
    B = x.shape[0]
    di, H, N, conv_ch, _ = _dims(cfg)
    conv_state, ssd_state = state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)

    xbc = torch.cat([xs, Bm, Cm], -1)[:, 0]                       # (B,conv_ch)
    win = torch.cat([conv_state, xbc[:, None]], 1)                # (B,w,conv_ch)
    cw = p["conv_w"].to(x.dtype)
    conv = torch.einsum("bwc,wc->bc", win, cw) + p["conv_b"].to(x.dtype)
    conv = F.silu(conv.to(torch.float32)).to(x.dtype)
    xs1, Bm1, Cm1 = torch.split(conv, [di, _G * N, _G * N], dim=-1)

    dt1, A = _dt_and_A(p, dt[:, 0])
    y, new_ssd = ssd_decode_step(
        ssd_state, xs1.reshape(B, H, cfg.ssm_head_dim), dt1, A,
        Bm1.reshape(B, _G, N), Cm1.reshape(B, _G, N),
        p["D"].to(torch.float32))
    y = y.reshape(B, 1, di)
    y = _gated_rmsnorm(p["norm_scale"], y, z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (win[:, 1:], new_ssd)
