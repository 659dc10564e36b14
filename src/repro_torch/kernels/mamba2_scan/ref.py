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


def ssd_backward_reference(x, dt, A, Bm, Cm, D, dy, init_state=None,
                           d_final_state=None, *, chunk: int = 64):
    """The gradient of ``ssd_chunked``'s ``(y, final_state)``: given ``dy``
    (B, S, H, P) and ``d_final_state`` (B, H, P, N) or None, returns
    ``(dx, ddt, dA, dBm, dCm, dD, d_init_state)`` in the inputs' dtypes
    (``d_init_state`` None without an ``init_state``). The plain backward:
    the CPU route of ``ops.ssd_scan`` under autograd and the yardstick the
    CUDA backward kernel is held against.

    Computed in float64, chunk by chunk, from the states themselves: a
    forward sweep keeps the state before each chunk; a reverse sweep
    carries the adjoint dS_t = dy_t C_t^T + a_{t+1} dS_{t+1} (dS_T adds
    d_final_state) and, within each chunk, forms every token's state S_t,
    the one before it and dS_t as (B, c, H, P, N) tensors. Then
        dx_t = dt_t g_t + D dy_t,       g_t = dS_t B_t
        dB_t = sum_h dt_t dS_t^T x_t,   dC_t = sum_h S_t^T dy_t
        ddt_t = x_t . g_t + A a_t <dS_t, S_{t-1}>
        dA = sum dt_t a_t <dS_t, S_{t-1}>,   dD = sum dy_t . x_t
    with no decay divided out and no cumulative sum of cancelling terms,
    so strong decay costs no digits."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    dev = x.device
    xf, dyf, dtf = x.to(_F64), dy.to(_F64), dt.to(_F64)
    Bf = _expand_groups(Bm.to(_F64), H)
    Cf = _expand_groups(Cm.to(_F64), H)
    Af, Df = A.to(_F64), D.to(_F64)
    la = dtf * Af                                    # (B,S,H) log a_t
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=dev))
    zero = torch.zeros((), dtype=_F64, device=dev)

    def chunk_states(c0, s_in):
        """S_t for every t of the chunk at c0, (B,c,H,P,N), from s_in."""
        cum = torch.cumsum(la[:, c0:c0 + chunk], dim=1)          # (B,c,H)
        rel = cum[:, :, None] - cum[:, None]                      # (B,t,s,H)
        W = torch.where(causal[None, :, :, None], torch.exp(rel), zero)
        dbx = dtf[:, c0:c0 + chunk, :, None] * xf[:, c0:c0 + chunk]
        return (torch.exp(cum)[..., None, None] * s_in[:, None]
                + torch.einsum("btsh,bshp,bshn->bthpn", W, dbx,
                               Bf[:, c0:c0 + chunk]))

    state = torch.zeros((B, H, P, N), dtype=_F64, device=dev) \
        if init_state is None else init_state.to(_F64)
    s_ins = []
    for c0 in range(0, S, chunk):
        s_ins.append(state)
        state = chunk_states(c0, state)[:, -1]

    carry = torch.zeros((B, H, P, N), dtype=_F64, device=dev) \
        if d_final_state is None else d_final_state.to(_F64)
    dx, ddt, dB, dC = (torch.empty(B, S, H, n, dtype=_F64, device=dev)
                       for n in (P, 1, N, N))
    dA = torch.zeros(H, dtype=_F64, device=dev)
    for ci in reversed(range(len(s_ins))):
        c0 = ci * chunk
        sl = slice(c0, c0 + chunk)
        st = chunk_states(c0, s_ins[ci])                          # S_t
        prev = torch.cat([s_ins[ci][:, None], st[:, :-1]], 1)     # S_{t-1}
        # dS_t = sum_{u>=t} exp(cum_u - cum_t) dy_u C_u^T
        #        + exp(cum_e - cum_t) carry
        cum = torch.cumsum(la[:, sl], dim=1)
        rel = cum[:, None] - cum[:, :, None]                      # (B,t,u,H)
        W = torch.where(causal.T[None, :, :, None], torch.exp(rel), zero)
        dS = (torch.exp(cum[:, -1:] - cum)[..., None, None] * carry[:, None]
              + torch.einsum("btuh,buhp,buhn->bthpn", W, dyf[:, sl],
                             Cf[:, sl]))
        g = torch.einsum("bthpn,bthn->bthp", dS, Bf[:, sl])
        dx[:, sl] = dtf[:, sl, :, None] * g + Df[:, None] * dyf[:, sl]
        dB[:, sl] = dtf[:, sl, :, None] * torch.einsum(
            "bthpn,bthp->bthn", dS, xf[:, sl])
        dC[:, sl] = torch.einsum("bthpn,bthp->bthn", st, dyf[:, sl])
        dla = torch.exp(la[:, sl]) * torch.einsum("bthpn,bthpn->bth", dS,
                                                  prev)
        ddt[:, sl, :, 0] = torch.sum(xf[:, sl] * g, -1) + Af * dla
        dA += torch.sum(dtf[:, sl] * dla, dim=(0, 1))
        carry = torch.exp(la[:, c0])[..., None, None] * dS[:, 0]
    dD = torch.einsum("bshp,bshp->h", dyf, xf)
    group = lambda m: m.reshape(B, S, G, H // G, N).sum(3)   # noqa: E731
    return (dx.to(x.dtype), ddt[..., 0].to(dt.dtype), dA.to(A.dtype),
            group(dB).to(Bm.dtype), group(dC).to(Cm.dtype), dD.to(D.dtype),
            None if init_state is None else carry.to(init_state.dtype))
