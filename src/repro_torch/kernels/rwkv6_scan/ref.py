"""Plain PyTorch versions of the RWKV-6 (Finch) WKV scan with a
data-dependent decay: the CPU path of ``ops.wkv6_scan`` and the yardstick
the CUDA kernel is held against.

  * ``wkv6_chunked``     — the chunked form the TPU kernel computes, with
                           the EXACT masked decay exp(cum_excl[t] - cum[u])
                           (u < t) per (chunk, chunk, K) tile; the op's
                           plain route.
  * ``wkv6_sequential``  — the literal per-timestep recurrence (ground
                           truth for the tests).
  * ``wkv6_decode_step`` — one token, the decode path.

Per head (K = head key dim, V = head value dim, here K == V == head_size):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
Shapes:
    r, k, w: (B, S, H, K)   v: (B, S, H, V)   u: (H, K)
    w in (0, 1): already exp(-exp(..)).   state: (B, H, K, V) float32
Returns y: (B, S, H, V) in ``r.dtype``, final_state.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def _init(init_state, B, H, K, V, device):
    if init_state is None:
        return torch.zeros((B, H, K, V), dtype=_F32, device=device)
    return init_state.to(_F32)


def wkv6_sequential(r, k, v, w, u, init_state=None):
    B, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (t.to(_F32) for t in (r, k, v, w))
    uf = u.to(_F32)
    state = _init(init_state, B, H, K, V, r.device)
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               state + uf[None, :, :, None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(ys, 1).to(r.dtype), state


def wkv6_chunked(r, k, v, w, u, init_state=None, *, chunk: int = 32):
    """Chunked WKV6 as the reference's TPU kernel computes it, chunk by
    chunk with the state carried between chunks. Within a chunk
    (positions t, u):
      y_t = r_t (D_{0:t} S_in + sum_{u<t} (D_{u+1:t} k_u) v_u^T
                 + diag(u_bonus) k_t v_t^T)
    with D_{a:b} = prod_{i=a}^{b-1} diag(w_i) built from cumsum(log w):
    D_{u+1:t} = exp(cum_excl[t] - cum[u]), whose exponent is <= 0 wherever
    the mask keeps it, so no decay overflows and nothing is clamped."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    uf = u.to(_F32)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)   # u < t
    zero = torch.zeros((), dtype=_F32, device=r.device)
    state = _init(init_state, B, H, K, V, r.device)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, wc = (t[:, c0:c0 + chunk].to(_F32) for t in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=1e-38))
        cum = torch.cumsum(logw, dim=1)              # (B,c,H,K) inclusive
        cum_excl = cum - logw
        total = cum[:, -1]                           # (B,H,K)

        # exact masked decay tile: rel[t,u,k] = cum_excl[t,k] - cum[u,k]
        rel = cum_excl[:, :, None] - cum[:, None, :]             # (B,t,u,H,K)
        dec = torch.where(tri[None, :, :, None, None], torch.exp(rel), zero)
        scores = torch.einsum("bthk,buhk,btuhk->bhtu", rc, kc, dec)
        diag = torch.sum(rc * uf * kc, dim=-1)       # (B,c,H)
        y_intra = (torch.einsum("bhtu,buhv->bthv", scores, vc)
                   + diag[..., None] * vc)
        y_inter = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cum_excl),
                               state)
        ys.append(y_intra + y_inter)

        k_tail = kc * torch.exp(total[:, None] - cum)            # (B,c,H,K)
        state = torch.exp(total)[..., None] * state \
            + torch.einsum("buhk,buhv->bhkv", k_tail, vc)
    return torch.cat(ys, 1).to(r.dtype), state


def wkv6_decode_step(state, r, k, v, w, u):
    """One token. r/k/w:(B,H,K) v:(B,H,V) state:(B,H,K,V) f32. Returns
    (y (B,H,V) in ``r.dtype``, new state)."""
    rf, kf, vf, wf = (t.to(_F32) for t in (r, k, v, w))
    uf = u.to(_F32)
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, state + uf[None, :, :, None] * kv)
    state = wf[..., :, None] * state + kv
    return y.to(r.dtype), state
