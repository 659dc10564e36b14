"""Plain PyTorch version of blocked (flash) GQA attention and of its
backward: the CPU path of ``ops.flash_attention`` and the yardstick the
CUDA kernels are held against.

Shapes (time-major per batch):
    q: (B, S_q, H, D)    k,v: (B, S_kv, KV, D)    with H % KV == 0.
Query head ``h`` reads KV head ``h // G`` (G = H // KV). Accumulation in
float32 regardless of input dtype; output in ``q.dtype``.
"""
from __future__ import annotations

import torch


def _group(x, KV: int):
    """(B, S, H, D) -> (B, KV, G, S, D): query head h = KV head h // G."""
    B, S, H, D = x.shape
    return x.reshape(B, S, KV, H // KV, D).permute(0, 2, 3, 1, 4)


def _ungroup(x):
    """(B, KV, G, S, D) -> (B, S, H, D)."""
    B, KV, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, KV * G, D)


def _visible(Sq: int, Skv: int, q_offset: int, device):
    """(Sq, Skv) mask: key u visible to query t when u <= t + q_offset."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    return kpos[None, :] <= qpos[:, None]


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        q_offset: int | None = None,
                        return_lse: bool = False):
    """O(S^2) reference attention with GQA head-group broadcast.

    ``q_offset``: absolute position of q[0] relative to k[0] (for chunked /
    decode use). Defaults to S_kv - S_q (q block ends aligned with kv end).
    With ``return_lse`` also each row's log-sum-exp of the scaled scores,
    (B, H, Sq) f32, as the kernel writes it for the backward.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Skv - Sq

    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    # (B, KV, G, Sq, D) x (B, KV, Skv, D) -> (B, KV, G, Sq, Skv)
    qg = _group(qf, KV)
    kg = kf.permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bkud->bkgqu", qg, kg)

    if causal:
        s = torch.where(_visible(Sq, Skv, q_offset, q.device), s, -torch.inf)

    mx = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / denom
    vg = vf.permute(0, 2, 1, 3)
    o = torch.einsum("bkgqu,bkud->bkgqd", p, vg)
    o = _ungroup(o)
    if not return_lse:
        return o.to(q.dtype)
    lse = (mx + torch.log(denom))[..., 0].reshape(B, H, Sq)
    return o.to(q.dtype), lse


def attention_backward_reference(q, k, v, o, lse, do, causal: bool = True):
    """The gradients (dq, dk, dv) of ``attention_reference`` (bottom-right
    causal mask, GQA), written out step by step from the forward's output
    ``o`` and row log-sum-exp ``lse`` (B, H, Sq), given the output's
    gradient ``do``; scale D**-0.5 as the forward's default; f32
    throughout, each result in its input's dtype:

        P  = exp(scale * Q K^T - lse)    (masked entries 0)
        D  = rowsum(dO o O)
        dV = P^T dO                       summed over the G heads of a KV head
        dS = P o (dO V^T - D)
        dQ = scale * dS K
        dK = scale * dS^T Q               summed over the G heads
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = D ** -0.5
    f32 = torch.float32
    qg, og, dog = (_group(t.to(f32), KV) for t in (q, o, do))
    kg, vg = (t.to(f32).permute(0, 2, 1, 3) for t in (k, v))
    s = torch.einsum("bkgqd,bkud->bkgqu", qg, kg) * scale
    p = torch.exp(s - lse.reshape(B, KV, H // KV, Sq, 1))
    if causal:
        p = torch.where(_visible(Sq, Skv, Skv - Sq, q.device), p, 0.0)
    delta = torch.sum(dog * og, dim=-1, keepdim=True)
    dv = torch.einsum("bkgqu,bkgqd->bkud", p, dog)
    dp = torch.einsum("bkgqd,bkud->bkgqu", dog, vg)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqu,bkud->bkgqd", ds, kg) * scale
    dk = torch.einsum("bkgqu,bkgqd->bkud", ds, qg) * scale
    return (_ungroup(dq).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
