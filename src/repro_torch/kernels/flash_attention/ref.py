"""Plain PyTorch version of blocked (flash) GQA attention: the CPU path of
``ops.flash_attention`` and the yardstick the CUDA kernel is held against.

Shapes (time-major per batch):
    q: (B, S_q, H, D)    k,v: (B, S_kv, KV, D)    with H % KV == 0.
Query head ``h`` reads KV head ``h // G`` (G = H // KV). Accumulation in
float32 regardless of input dtype; output in ``q.dtype``.
"""
from __future__ import annotations

import torch


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        q_offset: int | None = None):
    """O(S^2) reference attention with GQA head-group broadcast.

    ``q_offset``: absolute position of q[0] relative to k[0] (for chunked /
    decode use). Defaults to S_kv - S_q (q block ends aligned with kv end).
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Skv - Sq

    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    # (B, KV, G, Sq, D) x (B, KV, Skv, D) -> (B, KV, G, Sq, Skv)
    qg = qf.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kg = kf.permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bkud->bkgqu", qg, kg)

    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask[None, None, None], s, -torch.inf)

    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    vg = vf.permute(0, 2, 1, 3)
    o = torch.einsum("bkgqu,bkud->bkgqd", p, vg)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return o.to(q.dtype)
