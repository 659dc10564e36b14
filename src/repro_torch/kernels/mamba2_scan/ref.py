"""Plain PyTorch versions of the Mamba2 SSD scan: the CPU path of
``ops.ssd_scan`` and the yardstick the CUDA kernel is held against.

  * ``ssd_chunked``    — the chunked decomposition the TPU kernel computes
                         (dense (chunk x chunk) / (chunk x N) products and
                         an n_chunks-long state recurrence), in float64;
                         the op's plain route.
  * ``ssd_sequential`` — the literal per-timestep recurrence (ground truth
                         for the tests).
  * ``ssd_decode_step`` — one token, the decode path.

Shapes (G = groups; H heads, P head channels, N state):
    x:  (B, S, H, P)     dt: (B, S, H)       A: (H,)   [negative decay rates]
    Bm: (B, S, G, N)     Cm: (B, S, G, N)    D: (H,)
    init_state: (B, H, P, N) or None
Returns y: (B, S, H, P) in ``x.dtype``, final_state: (B, H, P, N) float32.

Recurrence (per head h, discretised):
    a_t = exp(dt_t * A_h)                         scalar per (t, h)
    S_t = a_t * S_{t-1} + dt_t * x_t B_t^T        (P, N)
    y_t = S_t C_t + D_h * x_t
"""
from __future__ import annotations

import torch

_F32 = torch.float32
_F64 = torch.float64


def _expand_groups(m, H):
    # (B, S, G, N) -> (B, S, H, N) by repeating each group over its heads
    G = m.shape[2]
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    return torch.repeat_interleave(m, H // G, dim=2)


def _init(init_state, B, H, P, N, device):
    if init_state is None:
        return torch.zeros((B, H, P, N), dtype=_F32, device=device)
    return init_state.to(_F32)


def ssd_sequential(x, dt, A, Bm, Cm, D, init_state=None):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af, Df = (t.to(_F32) for t in (x, dt, A, D))
    Bf = _expand_groups(Bm.to(_F32), H)
    Cf = _expand_groups(Cm.to(_F32), H)
    state = _init(init_state, B, H, P, N, x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)[..., None, None]          # (B,H,1,1)
        dbx = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bf[:, t, :, None, :]                               # (B,H,P,N)
        state = a * state + dbx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t])
                  + Df[None, :, None] * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), state


def ssd_chunked(x, dt, A, Bm, Cm, D, init_state=None, *, chunk: int = 64):
    """Chunked SSD: intra-chunk dense products + inter-chunk state
    recurrence, the decomposition of the reference's ``ssd_chunked``.

    Computed in float64, y cast back to ``x.dtype`` and the state to f32:
    the decays are exp of differences of cumulative sums of dt * A, and
    at strong decay (dt |A| of a few units) those differences of large
    sums lose f32 digits the per-token recurrence keeps."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk

    xf = x.to(_F64).reshape(B, nc, chunk, H, P)
    dtf = dt.to(_F64).reshape(B, nc, chunk, H)
    Bf = _expand_groups(Bm.to(_F64), H).reshape(B, nc, chunk, H, N)
    Cf = _expand_groups(Cm.to(_F64), H).reshape(B, nc, chunk, H, N)
    Af = A.to(_F64)

    # cumulative log-decay within each chunk: l[t] = sum_{u<=t} dt_u * A
    seg = dtf * Af[None, None, None, :]              # (B,nc,c,H)
    cum = torch.cumsum(seg, dim=2)                   # inclusive
    total = cum[:, :, -1, :]                         # (B,nc,H) chunk total

    # intra-chunk (causal) kernel: L[t,u] = exp(cum[t]-cum[u]) for u<=t;
    # the masked entries are selected away, never multiplied
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,c,c,H)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                    torch.zeros((), dtype=_F64, device=x.device))

    # y_intra[t] = sum_{u<=t} L[t,u] * (C_t . B_u) * dt_u * x_u
    CB = torch.einsum("bcthn,bcuhn->bctuh", Cf, Bf)
    dx = dtf[..., None] * xf                         # (B,nc,c,H,P)
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", CB * L, dx)

    # chunk state contribution: sum_u exp(total - cum[u]) dt_u x_u B_u^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum)     # (B,nc,c,H)
    SB = torch.einsum("bcuh,bcuhp,bcuhn->bchpn", decay_to_end * dtf, xf, Bf)

    # inter-chunk recurrence over nc chunks; keep the state BEFORE each
    state = _init(init_state, B, H, P, N, x.device).to(_F64)
    chunk_decay = torch.exp(total)                   # (B,nc,H)
    prev_states = []
    for c in range(nc):
        prev_states.append(state)
        state = chunk_decay[:, c, :, None, None] * state + SB[:, c]
    prev = torch.stack(prev_states, 1)               # (B,nc,H,P,N)

    # y_inter[t] = C_t . (exp(cum[t]) * prev_state)
    y_inter = torch.einsum("bcthn,bchpn,bcth->bcthp", Cf, prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + D.to(_F64)[None, None, :, None] * x.to(_F64)
    return y.to(x.dtype), state.to(_F32)


def ssd_decode_step(state, x, dt, A, Bm, Cm, D):
    """One-token state update. x:(B,H,P) dt:(B,H) Bm/Cm:(B,G,N)
    state:(B,H,P,N) f32. Returns (y (B,H,P) in ``x.dtype``, new state)."""
    H = x.shape[1]
    Bf = torch.repeat_interleave(Bm.to(_F32), H // Bm.shape[1], dim=1)
    Cf = torch.repeat_interleave(Cm.to(_F32), H // Cm.shape[1], dim=1)
    xf, dtf = x.to(_F32), dt.to(_F32)
    a = torch.exp(dtf * A.to(_F32))[..., None, None]
    state = a * state + (dtf[..., None] * xf)[..., None] * Bf[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cf) \
        + D.to(_F32)[None, :, None] * xf
    return y.to(x.dtype), state
