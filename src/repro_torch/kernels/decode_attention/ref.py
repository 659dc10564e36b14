"""Plain PyTorch version of single-token GQA decode attention against a KV
cache: the CPU path of ``ops.decode_attention`` and the yardstick the CUDA
kernel is held against.

    q:        (B, H, D)        one new token per request
    k_cache:  (B, S, KV, D)
    v_cache:  (B, S, KV, D)
    lengths:  (B,) int32       number of valid cache entries per request
Returns (B, H, D). float32 accumulation; the probabilities are rounded to
the cache dtype before the second product, as in the reference.
"""
from __future__ import annotations

import torch


def decode_attention_reference(q, k_cache, v_cache, lengths, *,
                               scale: float | None = None):
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    assert H % KV == 0
    G = H // KV
    if scale is None:
        scale = D ** -0.5

    # products of the native (bf16) operands summed in f32: upcasting
    # first is exact, and the scale applies to the f32 scores
    qg = q.reshape(B, KV, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])                              # (B, S)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    p = p.to(v_cache.dtype).to(torch.float32)
    o = torch.einsum("bkgs,bskd->bkgd", p,
                     v_cache.to(torch.float32)).reshape(B, H, D)
    return o.to(q.dtype)
