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


#: the max a row with no valid slot reports (the reference's ``NEG_INF``,
#: ``src/repro/kernels/decode_attention/distributed.py``): finite, so the
#: shards' ``exp(m - max m)`` is never ``exp(-inf + inf)``
NEG_INF = -1e30


def decode_attention_partial_reference(q, k_cache, v_cache, lengths):
    """Plain version of the stats route: the unnormalised attention of each
    query head over the cache's first ``lengths[b]`` slots, as the
    reference's ``_partial`` computes it at offset 0. Returns ``(o (B,H,D),
    m (B,H), l (B,H))`` in f32: ``o = sum_s p_s v_s`` with ``p_s = exp(s_s
    - m)`` rounded to the cache dtype before the product, ``m`` the largest
    valid score (``NEG_INF`` where none is valid), ``l = sum_s p_s``."""
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qg = q.reshape(B, KV, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * (D ** -0.5)
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]           # (B,1,1,S)
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1)                                # (B,KV,G)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)
