"""The arithmetic of the bf16 route of ``ssd_scan``'s backward
(``ssd_scan_tc_kernel<kStates>`` then ``ssd_scan_bwd_tc_kernel`` in
``csrc/ssd_scan.cu``), modelled chunk by chunk in plain PyTorch on the CPU
(the kernels themselves run only on a card, in
test_torch_scan_backward_gpu.py):

* the state sweep: the forward's state update with (w x)^T in three bf16
  parts, the state before each chunk kept as three bf16 planes;
* the reverse sweep: cum = cumsum(dt A) in float64, L[t,u] = exp(cum_t -
  cum_u) formed directly inside a 16-token tile and as a product of two
  factors across tiles; G, Dyx exact; dX = w (B dS^T) + M^T dY + D dY, dB =
  w (X dS) + W^T C, dC = exp(cum) (dY S_prev) + W B per head, the adjoint
  exp(total) dS + (exp(cum) dY)^T C; the log-decay gradient from q, k and
  the row and column sums rs, cs of R = G o Dyx o L dt (float64 sums and
  scans), dS kept as three planes between chunks;

with every operand that is not a bf16 input split into bf16 parts (hi =
bf16(f), then bf16 of what is left): three where its products reach ddt or
dA (the state, S_prev, dS in X dS, exp(cum) dY), two elsewhere. The model
is held against the float64 plain backward (``ssd_backward_reference``)
and against ``jax.vjp`` of the JAX package's ``ssd_chunked`` at the card's
tolerance (``chip_smoke.SCAN_BWD_TOL``): bf16 gradients 2e-2, the f32 ones
(ddt, dA, dD) 1e-3 on ``|got - ref| / (1 + |ref|)``. A single rounding of
any split operand misses it; two parts for the adjoint's leave ddt no
margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import ref as jssd
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.mamba2_scan.ref import ssd_backward_reference

torch.set_num_threads(1)

_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
TOL = {"float32": 1e-3, "bfloat16": 2e-2}      # chip_smoke.SCAN_BWD_TOL
GRADS = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
#: bf16 parts of each operand that is not a bf16 input, as the kernels take it
DESIGN_PARTS = {"state": 3, "S_prev": 3, "dS_Z": 3, "ydecay": 3,
                "dS_dx": 2, "M": 2, "W": 2}
TILE = 16                                       # the decays' factor tiles


def _parts(t, n):
    """f32 as n bf16 parts (as f32): hi = bf16(f), then bf16 of the rest."""
    out = []
    for _ in range(n):
        p = t.to(_BF16).to(_F32)
        out.append(p)
        t = t - p
    return out


def _mm(a, b, na=0, nb=0):
    """a @ b, a (or b) in na (nb) bf16 parts, the other operand exact;
    0 keeps an operand as it is (a bf16 input)."""
    pa = _parts(a, na) if na else [a]
    pb = _parts(b, nb) if nb else [b]
    return sum(x @ y for x in pa for y in pb)


def _decays(cum64, chunk):
    """L[t,u] = exp(cum_t - cum_u) for u <= t as the kernel forms it:
    directly inside a 16-token tile, across tiles din_t exp(cum_s - cum_u)
    with s the first token of t's tile; exponents in float64, rounded to
    f32 before exp."""
    t = torch.arange(chunk)
    s = (t // TILE) * TILE
    ex = lambda d: torch.exp(d.to(_F32))                         # noqa: E731
    direct = ex(cum64[..., :, None] - cum64[..., None, :])
    din = ex(cum64 - cum64[..., s])                              # (.., t)
    across = din[..., :, None] * ex(cum64[..., s][..., :, None]
                                    - cum64[..., None, :])
    same = (t[:, None] // TILE) == (t[None, :] // TILE)
    causal = t[:, None] >= t[None, :]
    return torch.where(causal, torch.where(same, direct, across), 0.0)


def ssd_bwd_tc_model(x, dt, A, Bm, Cm, D, dy, d_final=None, *,
                     chunk=ssd_kernel.TC_CHUNK, parts=None):
    """The bf16 route's gradients (dx, ddt, dA, dBm, dCm, dD) of the
    zero-initial-state scan: bf16 x, Bm, Cm (one group), dy; f32 dt, A, D
    and d_final (or None). S is padded to whole chunks with zeros (a zero
    dt makes a padded token a no-op). ``parts`` overrides the bf16 parts
    of an operand of ``DESIGN_PARTS``."""
    n = dict(DESIGN_PARTS, **(parts or {}))
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = -S % chunk
    f = torch.nn.functional.pad
    xf = f(x.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)   # (B,H,S,P)
    dyf = f(dy.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    dtf = f(dt.float(), (0, 0, 0, pad)).permute(0, 2, 1)          # (B,H,S)
    Bf = f(Bm.float()[:, :, 0], (0, 0, 0, pad))[:, None]          # (B,1,S,N)
    Cf = f(Cm.float()[:, :, 0], (0, 0, 0, pad))[:, None]
    nck = (S + pad) // chunk
    strict = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)

    def chunk_decays(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        cum64 = torch.cumsum(dtf[..., sl].double() * A.double()[:, None], -1)
        total = cum64[..., -1:]
        return (sl, cum64, torch.exp((total - cum64).float()),
                torch.exp(cum64.float()), torch.exp(total.float()))

    # the state sweep: the state before each chunk as bf16 planes
    state = torch.zeros(B, H, P, N)
    planes = []
    for c in range(nck):
        sl, _, erev, _, decay = chunk_decays(c)
        planes.append(_parts(state, n["S_prev"]))
        xw = (dtf[..., sl] * erev)[..., None] * xf[:, :, sl]
        state = decay[..., None] * state + _mm(
            xw.transpose(-1, -2), Bf[:, :, sl], na=n["state"])

    # the reverse sweep
    dS = torch.zeros(B, H, P, N) if d_final is None else d_final.float()
    dx = torch.zeros(B, H, nck * chunk, P)
    ddt = torch.zeros(B, H, nck * chunk)
    dBh, dCh = (torch.zeros(B, H, nck * chunk, N) for _ in range(2))
    dA = torch.zeros(B, H, dtype=_F64)
    dD = torch.zeros(B, H)
    for c in reversed(range(nck)):
        sl, cum64, erev, ecum, decay = chunk_decays(c)
        xc, dyc, dc = xf[:, :, sl], dyf[:, :, sl], dtf[..., sl]
        Bc, Cc = Bf[:, :, sl], Cf[:, :, sl]
        dS = sum(_parts(dS, 3))                 # between chunks: 3 planes
        sp = planes[c]
        L = _decays(cum64, chunk)
        G = Cc @ Bc.transpose(-1, -2)           # exact: bf16 products
        Dyx = dyc @ xc.transpose(-1, -2)
        T = G * Dyx * L
        R = T * dc[..., None, :]
        M = G * L * dc[..., None, :]
        W = Dyx * L * dc[..., None, :]
        w = dc * erev
        dxc = w[..., None] * _mm(Bc, dS.transpose(-1, -2), nb=n["dS_dx"])
        dx[:, :, sl] = dxc + _mm(M.transpose(-1, -2), dyc, na=n["M"]) \
            + D[None, :, None, None] * dyc
        Z = _mm(xc, dS, nb=n["dS_Z"])
        qp = erev * (Z * Bc).sum(-1)
        dBh[:, :, sl] = w[..., None] * Z + _mm(W.transpose(-1, -2), Cc,
                                               na=n["W"])
        V = sum(dyc @ p for p in sp)
        k = ecum * (V * Cc).sum(-1)
        dCh[:, :, sl] = ecum[..., None] * V + _mm(W, Bc, na=n["W"])
        rs = torch.where(strict, R, 0.0).double().sum(-1)
        cs = torch.where(strict, R, 0.0).double().sum(-2)
        direct = T.sum(-2) + qp
        s0 = decay[..., 0] * (dS * sum(sp)).sum((-1, -2))
        e = k.double() + rs - cs
        suffix = torch.flip(torch.cumsum(torch.flip(e, [-1]), -1), [-1])
        q = (dc * qp).double()
        prefix = torch.cumsum(q, -1) - q
        dseg = s0.double()[..., None] + prefix + suffix
        ddt[..., sl] = (direct.double() + A.double()[:, None] * dseg).float()
        dA += (dc.double() * dseg).sum(-1)
        dD += torch.diagonal(Dyx, dim1=-2, dim2=-1).sum(-1)
        dS = decay[..., None] * dS + _mm(
            (ecum[..., None] * dyc).transpose(-1, -2), Cc, na=n["ydecay"])
    return (dx[:, :, :S].permute(0, 2, 1, 3).to(x.dtype),
            ddt[..., :S].permute(0, 2, 1), dA.sum(0).float(),
            dBh.sum(1)[:, :S, None].to(Bm.dtype),
            dCh.sum(1)[:, :S, None].to(Cm.dtype), dD.sum(0))


def _inputs(seed, B, S, H, P, N, dt_range):
    """x, Bm, Cm, dy bf16-representable (as numpy f32), dt, A, D, dF f32."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(torch.tensor(a.astype(np.float32))   # noqa: E731
                              .to(_BF16).float())
    return dict(x=bf(rng.normal(size=(B, S, H, P))),
                dt=rng.uniform(*dt_range, (B, S, H)).astype(np.float32),
                A=(-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
                Bm=bf(rng.normal(size=(B, S, 1, N))),
                Cm=bf(rng.normal(size=(B, S, 1, N))),
                D=rng.normal(size=(H,)).astype(np.float32),
                dy=bf(rng.normal(size=(B, S, H, P))),
                dF=rng.normal(size=(B, H, P, N)).astype(np.float32))


def _torch(a):
    t = {k: torch.tensor(v) for k, v in a.items()}
    for k in ("x", "Bm", "Cm", "dy"):
        t[k] = t[k].to(_BF16)
    return t


ARGS = ("x", "dt", "A", "Bm", "Cm", "D", "dy")


def _model(a, final, **kw):
    t = _torch(a)
    return ssd_bwd_tc_model(*(t[k] for k in ARGS),
                            t["dF"] if final else None, **kw)


def _reference(a, final, chunk):
    t = _torch(a)
    return ssd_backward_reference(*(t[k] for k in ARGS), None,
                                  t["dF"] if final else None,
                                  chunk=chunk)[:6]


def _errors(got, want):
    """Each gradient's error on |got - ref| / (1 + |ref|) and its
    tolerance: f32 gradients 1e-3, bf16 ones 2e-2."""
    out = {}
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g.double()), np.asarray(w.double())
        assert g.shape == w.shape
        rel = float((np.abs(g - w) / (1 + np.abs(w))).max())
        tol = TOL["float32" if w.dtype == np.float64 and name in
                  ("ddt", "dA", "dD") else "bfloat16"]
        out[name] = (rel, tol)
    return out


def _meets(errs) -> bool:
    return all(rel <= tol for rel, tol in errs.values())


SSD_MILD, SSD_STRONG = (1e-3, 0.1), (1.0, 5.0)
# (B, S, H, P, N, the reference's chunk): the CPU tests' shapes, a ragged
# S (100: two chunks, the last short), P 20 (not a multiple of 8) and N 48
SHAPES = [(2, 64, 3, 8, 16, 16), (1, 96, 2, 16, 32, 32),
          (2, 100, 2, 64, 64, 50), (1, 128, 2, 20, 32, 32),
          (1, 128, 2, 64, 48, 64)]


@pytest.mark.parametrize("final", [False, True],
                         ids=["no_final_grad", "final_grad"])
@pytest.mark.parametrize("dt_range", [SSD_MILD, SSD_STRONG],
                         ids=["mild", "strong"])      # dt |A| up to 10
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_backward_design_matches_the_plain_backward(shape, dt_range,
                                                        final):
    *dims, chunk = shape
    a = _inputs(30, *dims, dt_range)
    got = _model(a, final)
    assert [g.dtype for g in got] == [_BF16, _F32, _F32, _BF16, _BF16, _F32]
    assert all(torch.isfinite(g.float()).all() for g in got)
    errs = _errors(got, _reference(a, final, chunk))
    assert _meets(errs), errs


@pytest.mark.parametrize("final", [False, True],
                         ids=["no_final_grad", "final_grad"])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_ssd_backward_design_matches_jax_grad(shape, final):
    """Against jax.vjp of the JAX package's chunked form in f32, run as
    test_torch_scan_backward.py runs it (mild decay: at strong decay its
    masked exponentials overflow)."""
    *dims, chunk = shape
    a = _inputs(31, *dims, SSD_MILD)
    args = [jnp.asarray(a[k]) for k in ("x", "dt", "A", "Bm", "Cm", "D")]
    y, vjp = jax.vjp(lambda *t: jssd.ssd_chunked(*t, chunk=chunk), *args)
    want = vjp((jnp.asarray(a["dy"]), jnp.asarray(a["dF"]) if final
                else jnp.zeros_like(y[1])))
    errs = _errors(_model(a, final),
                   [torch.tensor(np.asarray(w)) for w in want])
    assert _meets(errs), errs


@pytest.mark.parametrize("dt_range", [SSD_MILD, SSD_STRONG],
                         ids=["mild", "strong"])
def test_ssd_backward_design_at_the_path_length(dt_range):
    """One head of the zamba2-2.7b training shape (S 1024, P = N = 64)
    with a final-state gradient: ddt, dA and dD meet the f32 1e-3."""
    a = _inputs(32, 1, 1024, 1, 64, 64, dt_range)
    errs = _errors(_model(a, True), _reference(a, True, 64))
    assert _meets(errs), errs


@pytest.mark.parametrize("operand", sorted(DESIGN_PARTS))
def test_ssd_backward_design_single_rounding_misses(operand):
    """One bf16 rounding of any operand the design splits misses the
    tolerance at the path length and strong decay (dt |A| up to 10); the
    design meets it on the same inputs."""
    a = _inputs(33, 1, 1024, 1, 64, 64, SSD_STRONG)
    want = _reference(a, True, 64)
    assert _meets(_errors(_model(a, True), want))
    errs = _errors(_model(a, True, parts={operand: 1}), want)
    assert not _meets(errs), errs


def test_ssd_backward_design_two_part_adjoint_leaves_ddt_no_margin():
    """The adjoint's operands (dS in X dS, exp(cum) dY in the update) in
    two parts, as the forward splits its own, leave ddt over 16 heads of
    the path length past half its 1e-3 and ten times the design's error:
    ddt is a difference of terms a thousand times larger than itself at
    some tokens, and the path has 320 heads (on the card two parts read
    1.4e-3 to 2.3e-3 there). Three parts keep it far inside."""
    a = _inputs(34, 1, 1024, 16, 64, 64, SSD_MILD)
    want = _reference(a, False, 64)
    errs = _errors(_model(a, False), want)
    assert _meets(errs), errs
    two = _errors(_model(a, False, parts={"dS_Z": 2, "ydecay": 2}), want)
    rel, tol = two["ddt"]
    assert rel > tol / 2 and rel > 10 * errs["ddt"][0], (two, errs)


def test_backward_route_geometry():
    """The reverse sweep's shared memory fits 2 blocks an SM, its
    constants are the source's own, and the bf16 route's states (three
    bf16 planes every 64 tokens) take three eighths of the f32 route's
    (one f32 state every 16 tokens) at the path shape."""
    mod = ssd_kernel
    assert mod.blocks_per_sm(mod.BWD_TC_SMEM_BYTES) == 2
    text = mod.SOURCE.read_text()
    assert f"constexpr int kBwdTcThreads = {mod.BWD_TC_THREADS};" in text
    assert f"{mod.BWD_TC_SMEM_BYTES:,}" in text.split(
        "kBwdTcSmemBytes =")[1].split("\n")[0]
    assert mod.backward_states_bytes(4, 1024, 80, _BF16) == 125_829_120
    assert mod.backward_states_bytes(4, 1024, 80, _F32) == 335_544_320
