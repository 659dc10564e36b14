"""The arithmetic of the bf16 route of ``wkv6_scan``'s backward
(``wkv6_scan_tc_kernel<kVec, kStates>`` then ``wkv6_scan_bwd_tc_kernel`` in
``csrc/wkv6_scan.cu``), modelled chunk by chunk in plain PyTorch on the CPU
(the kernels themselves run only on a card, in
test_torch_scan_backward_gpu.py):

* the state sweep: the forward's state update (k times the product of w
  to the chunk's end, as bf16 hi + lo, against v), the state entering each
  32-token chunk kept as bf16 hi and lo planes;
* the reverse sweep, per chunk, with a_t = prod_{i<t} w_i (since the
  chunk's start), g_t = prod_{t<i<c} w_i (to its end), and each pair u < t
  of the chunk taken at the level l (16, 8, 4, 2, 1) where t lies in the
  upper and u in the lower half of an aligned 2l-token block, m its middle,
  its decay the product of an upper factor prod_{m<=i<t} w_i and a lower
  factor prod_{u<i<m} w_i (the level's operand tile holds r times the one
  for an upper token, k times the other for a lower one):
    M = dY V^T (exact), Z its strictly lower part made symmetric;
    PQ_l = (Z at level l) Lop_l: the level's dr product for its upper
    tokens and its dk product for its lower ones, before their factors;
    E = dY S_in^T, F = V dS_end^T;
    dr = a o E + sum_l [upper] fac_l o PQ_l + u o k (v . dy);
    dk = g o F + sum_l [lower] fac_l o PQ_l + u o r (v . dy);
    dv = A^T dY + (k o g) dS_end, A the forward's levelled scores with the
    bonus on its diagonal;
    dw = (a g) o rowsum(S_in o dS_end) + a o R + g o L + sum_l fac_l o S_l,
    R a reverse scan of r o E over the chunk, L a forward scan of k o F,
    S_l a reverse scan of r o PQ_l over an upper half or a forward scan of
    k o PQ_l over a lower half: every factor a product of decays in (0, 1],
    no division by w;
    dS_in = diag(prod w) dS_end + (r o a)^T dY, dS an f32 sum;

with every operand that is not a bf16 input split into bf16 hi = bf16(f)
and lo = bf16(f - hi), Z into three parts (``DESIGN_PARTS``), and every
sum, scan and factor in f32 as the kernel takes it. The model is held against the float64 plain
backward (``wkv6_backward_reference``) at w down to 1e-30 and against
``jax.vjp`` of the JAX package's ``wkv6_sequential`` and ``wkv6_chunked``
(at w >= 0.4, short of its clamp) at the card's tolerance
(``chip_smoke.SCAN_BWD_TOL``): bf16 gradients 2e-2, the f32 ones (dw, du)
1e-3 on ``|got - ref| / (1 + |ref|)``. A single rounding of any split
operand misses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import ref as jwkv
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan.ref import wkv6_backward_reference

torch.set_num_threads(1)

_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
TOL = {"float32": 1e-3, "bfloat16": 2e-2}      # chip_smoke.SCAN_BWD_TOL
GRADS = ("dr", "dk", "dv", "dw", "du")
#: bf16 parts of each operand that is not a bf16 input, as the kernels take
#: it: the state sweep's k o g, the saved state S_in, dS_end's planes, the
#: symmetric M (three: its products reach dw through the level scans), the
#: level operands, the scores A, k o g against dS_end, r o a in the
#: adjoint's update
DESIGN_PARTS = {"sweep_kt": 2, "S_in": 2, "dS": 2, "Z": 3, "levels": 2,
                "A": 2, "kt": 2, "rdec": 2}
LEVELS = wkv_kernel.LEVELS


def _parts(t, n):
    """f32 as n bf16 parts (as f32): hi = bf16(f), then bf16 of the rest."""
    out = []
    for _ in range(n):
        p = t.to(_BF16).to(_F32)
        out.append(p)
        t = t - p
    return out


def _mm(a, b, na=0, nb=0):
    """a @ b in f32 with a (b) in na (nb) bf16 parts, 0 for an operand that
    is a bf16 input; the products whose parts' ranks sum past the larger
    split's are left out (two by two parts: hi hi, hi lo, lo hi)."""
    pa = _parts(a, na) if na else [a]
    pb = _parts(b, nb) if nb else [b]
    top = max(na, nb, 1)
    return sum(x @ y for i, x in enumerate(pa) for j, y in enumerate(pb)
               if i + j < top)


def _excl_cumprod(w, dim):
    """prod of w over the indices before each one along dim (1 first)."""
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, w.narrow(dim, 0, w.shape[dim] - 1)],
                                   dim), dim)


def _flip(t):
    return torch.flip(t, [-2])


def _halves(t, lv):
    """(B, H, c, K) as (B, H, c / 2lv, 2, lv, K): each aligned 2lv-token
    block's lower and upper half."""
    B, H, c, K = t.shape
    return t.reshape(B, H, c // (2 * lv), 2, lv, K)


def _fwdscan(y, w):
    """L_0 = 0, L_{j+1} = w_j L_j + y_j along dim -2."""
    out = [torch.zeros_like(y[..., 0, :])]
    for j in range(y.shape[-2] - 1):
        out.append(w[..., j, :] * out[-1] + y[..., j, :])
    return torch.stack(out, -2)


def _revscan(z, w):
    """R_{n-1} = 0, R_j = w_{j+1} R_{j+1} + z_{j+1} along dim -2."""
    return _flip(_fwdscan(_flip(z), _flip(w)))


def _level(lv, c):
    """Per pair (t, s) of a chunk, the level at which they split: the
    highest bit of t ^ s (0 on the diagonal)."""
    x = torch.arange(c)[:, None] ^ torch.arange(c)[None, :]
    lvl = torch.zeros_like(x)
    for b in (16, 8, 4, 2, 1):
        lvl = torch.where((lvl == 0) & (x & b != 0), b, lvl)
    return lvl == lv


def wkv_bwd_tc_model(r, k, v, w, u, dy, d_final=None, *,
                     chunk=wkv_kernel.TC_CHUNK, parts=None):
    """The bf16 route's gradients (dr, dk, dv, dw, du) of the
    zero-initial-state scan: bf16 r, k, v, dy; f32 w, u and d_final (or
    None). S is padded to whole chunks with tokens that decay by 1 and add
    nothing. ``parts`` overrides the bf16 parts of an operand of
    ``DESIGN_PARTS``."""
    n = dict(DESIGN_PARTS, **(parts or {}))
    B, S, H, K = r.shape
    V = v.shape[-1]
    c = chunk
    pad = -S % c

    def prep(t, value=0.0):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad),
                                    value=value)
        return t.permute(0, 2, 1, 3)                          # (B,H,S,.)

    rf, kf, vf, dyf, wf = prep(r), prep(k), prep(v), prep(dy), prep(w, 1.0)
    uf = u.float()[None, :, None, :]                           # (1,H,1,K)
    nck = (S + pad) // c
    upper = {lv: ((torch.arange(c) // lv) % 2 == 1)[:, None] for lv in LEVELS}
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool), -1)

    def decays(ci):
        sl = slice(ci * c, (ci + 1) * c)
        wc = wf[:, :, sl]
        a = _excl_cumprod(wc, -2)                              # prod_{i<t}
        g = _flip(_excl_cumprod(_flip(wc), -2))                # prod_{i>t}
        fac = {}
        for lv in LEVELS[:-1]:                                 # 16, 8, 4, 2
            h = _halves(wc, lv)
            lo = _flip(_excl_cumprod(_flip(h[..., 0, :, :]), -2))
            hi = _excl_cumprod(h[..., 1, :, :], -2)
            fac[lv] = torch.stack([lo, hi], -3).reshape(wc.shape)
        return sl, wc, a, g, fac

    # the state sweep: the state entering each chunk as bf16 planes
    state = torch.zeros(B, H, K, V)
    planes = []
    for ci in range(nck):
        sl, wc, a, g, _ = decays(ci)
        planes.append(_parts(state, n["S_in"]))
        kt = kf[:, :, sl] * g
        state = (a[..., -1:, :] * wc[..., -1:, :]).transpose(-1, -2) * state \
            + _mm(kt.transpose(-1, -2), vf[:, :, sl], na=n["sweep_kt"])

    # the reverse sweep
    dS = torch.zeros(B, H, K, V) if d_final is None else d_final.float()
    dr, dk, dw = (torch.zeros(B, H, nck * c, K) for _ in range(3))
    dv = torch.zeros(B, H, nck * c, V)
    du = torch.zeros(B, H, K)
    for ci in reversed(range(nck)):
        sl, wc, a, g, fac = decays(ci)
        rc, kc, vc, dyc = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], dyf[:, :, sl]
        s_in = planes[ci]
        ds_p = _parts(dS, n["dS"])
        # the level operands: r times the upper factor, k times the lower
        lop = {lv: torch.where(upper[lv], rc, kc) * fac[lv]
               for lv in LEVELS[:-1]}
        lop[1] = torch.where(upper[1], rc, kc)
        # the forward's scores A (bonus on the diagonal)
        A = torch.diag_embed((rc * uf * kc).sum(-1))
        for lv in LEVELS:
            prod = _mm(lop[lv], lop[lv].transpose(-1, -2),
                       n["levels"] if lv > 1 else 0,
                       n["levels"] if lv > 1 else 0)
            mask = _level(lv, c) & strict
            A = torch.where(mask, prod, A)
        # M = dY V^T, exact in f32; Z its strict lower part, symmetric
        Mx = dyc @ vc.transpose(-1, -2)
        p = torch.diagonal(Mx, dim1=-2, dim2=-1)[..., None]   # v_t . dy_t
        Zs = torch.where(strict, Mx, 0.0)
        Z = Zs + Zs.transpose(-1, -2)
        E = sum(dyc @ sp.transpose(-1, -2) for sp in s_in)
        F = sum(vc @ dp.transpose(-1, -2) for dp in ds_p)
        s1 = (sum(s_in) * sum(ds_p)).sum(-1)[..., None, :]    # (B,H,1,K)
        drc = a * E + uf * kc * p
        dkc = g * F + uf * rc * p
        dwc = a * g * s1 + a * _revscan(rc * E, wc) + g * _fwdscan(kc * F, wc)
        for lv in LEVELS:
            zl = torch.where(_level(lv, c), Z, 0.0)
            pq = _mm(zl, lop[lv], n["Z"], n["levels"] if lv > 1 else 0)
            if lv == 1:
                drc = drc + torch.where(upper[1], pq, 0.0)
                dkc = dkc + torch.where(upper[1], 0.0, pq)
                continue
            f = fac[lv]
            drc = drc + torch.where(upper[lv], f * pq, 0.0)
            dkc = dkc + torch.where(upper[lv], 0.0, f * pq)
            hz, hy, hw = (_halves(t, lv) for t in (rc * pq, kc * pq, wc))
            scan = torch.stack([_fwdscan(hy[..., 0, :, :], hw[..., 0, :, :]),
                                _revscan(hz[..., 1, :, :], hw[..., 1, :, :])],
                               -3).reshape(wc.shape)
            dwc = dwc + f * scan
        dvc = _mm(A.transpose(-1, -2), dyc, n["A"]) \
            + _mm(kc * g, dS, n["kt"], n["dS"])
        dr[:, :, sl], dk[:, :, sl], dw[:, :, sl], dv[:, :, sl] = \
            drc, dkc, dwc, dvc
        du += (rc * kc * p).sum(-2)
        dS = (a[..., -1:, :] * wc[..., -1:, :]).transpose(-1, -2) * dS \
            + _mm((rc * a).transpose(-1, -2), dyc, n["rdec"])
    out = lambda t: t[:, :, :S].permute(0, 2, 1, 3)            # noqa: E731
    return (out(dr).to(r.dtype), out(dk).to(k.dtype), out(dv).to(v.dtype),
            out(dw), du.sum(0))


def _inputs(seed, B, S, H, K, V, wmin):
    """r, k, v, dy bf16-representable (as numpy f32), w in (wmin, 0.999)
    (log-uniform below 1e-6, so decays near wmin occur), u, dF f32."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(torch.tensor(a.astype(np.float32))   # noqa: E731
                              .to(_BF16).float())
    if wmin >= 1e-6:
        w = rng.uniform(wmin, 0.999, (B, S, H, K))
    else:
        w = np.exp(rng.uniform(np.log(wmin), np.log(0.999), (B, S, H, K)))
    return dict(r=bf(rng.normal(size=(B, S, H, K))),
                k=bf(rng.normal(size=(B, S, H, K))),
                v=bf(rng.normal(size=(B, S, H, V))),
                w=w.astype(np.float32),
                u=rng.normal(size=(H, K)).astype(np.float32),
                dy=bf(rng.normal(size=(B, S, H, V))),
                dF=rng.normal(size=(B, H, K, V)).astype(np.float32))


ARGS = ("r", "k", "v", "w", "u", "dy")


def _torch(a):
    t = {n: torch.tensor(x) for n, x in a.items()}
    for n in ("r", "k", "v", "dy"):
        t[n] = t[n].to(_BF16)
    return t


def _model(a, final, **kw):
    t = _torch(a)
    return wkv_bwd_tc_model(*(t[n] for n in ARGS),
                            t["dF"] if final else None, **kw)


def _reference(a, final, chunk):
    t = _torch(a)
    return wkv6_backward_reference(*(t[n] for n in ARGS), None,
                                   t["dF"] if final else None,
                                   chunk=chunk)[:5]


def _errors(got, want):
    """Each gradient's error on |got - ref| / (1 + |ref|) and its
    tolerance: dw and du (f32 outputs) 1e-3, the bf16 ones 2e-2."""
    out = {}
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g.double()), np.asarray(w.double())
        assert g.shape == w.shape
        rel = float((np.abs(g - w) / (1 + np.abs(w))).max())
        out[name] = (rel, TOL["float32" if name in ("dw", "du")
                              else "bfloat16"])
    return out


def _meets(errs) -> bool:
    return all(rel <= tol for rel, tol in errs.values())


# (B, S, H, K, V, the reference's chunk): the CPU tests' shapes, a ragged
# S (100: the last 32-token chunk short), K 48, and V 50 beside K 64
SHAPES = [(2, 64, 3, 16, 16, 16), (1, 96, 2, 32, 32, 32),
          (2, 100, 2, 64, 64, 50), (1, 128, 2, 48, 48, 32),
          (1, 128, 2, 64, 50, 64)]


@pytest.mark.parametrize("final", [False, True],
                         ids=["no_final_grad", "final_grad"])
@pytest.mark.parametrize("wmin", [0.4, 1e-3, 1e-30])
@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_backward_design_matches_the_plain_backward(shape, wmin, final):
    *dims, chunk = shape
    a = _inputs(40, *dims, wmin)
    got = _model(a, final)
    assert [g.dtype for g in got] == [_BF16, _BF16, _BF16, _F32, _F32]
    assert all(torch.isfinite(g.float()).all() for g in got)
    errs = _errors(got, _reference(a, final, chunk))
    assert _meets(errs), errs


@pytest.mark.parametrize("form", ["sequential", "chunked"])
@pytest.mark.parametrize("final", [False, True],
                         ids=["no_final_grad", "final_grad"])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_wkv_backward_design_matches_jax_grad(shape, final, form):
    """Against jax.vjp of the JAX package's forms in f32, as
    test_torch_scan_backward.py runs them, at w >= 0.4: its chunked form
    clamps exp(-cum) at exp(80), reached below w = 0.37 over a chunk."""
    *dims, chunk = shape
    a = _inputs(41, *dims, 0.4)
    fn = (lambda *t: jwkv.wkv6_chunked(*t, chunk=chunk)) \
        if form == "chunked" else jwkv.wkv6_sequential
    args = [jnp.asarray(a[n]) for n in ("r", "k", "v", "w", "u")]
    y, vjp = jax.vjp(fn, *args)
    want = vjp((jnp.asarray(a["dy"]), jnp.asarray(a["dF"]) if final
                else jnp.zeros_like(y[1])))
    errs = _errors(_model(a, final),
                   [torch.tensor(np.asarray(w)) for w in want])
    assert _meets(errs), errs


@pytest.mark.parametrize("wmin", [0.4, 1e-30])
def test_wkv_backward_design_at_the_path_length(wmin):
    """One head of the rwkv6-7b training shape (S 1024, K = V = 64) with a
    final-state gradient: dw and du meet the f32 1e-3."""
    a = _inputs(42, 1, 1024, 1, 64, 64, wmin)
    errs = _errors(_model(a, True), _reference(a, True, 32))
    assert _meets(errs), errs


@pytest.mark.parametrize("operand", sorted(DESIGN_PARTS))
def test_wkv_backward_design_single_rounding_misses(operand):
    """One bf16 rounding of any operand the design splits misses the
    tolerance at the path length; the design meets it on the same
    inputs."""
    a = _inputs(43, 1, 1024, 1, 64, 64, 0.4)
    want = _reference(a, True, 32)
    assert _meets(_errors(_model(a, True), want))
    errs = _errors(_model(a, True, parts={operand: 1}), want)
    assert not _meets(errs), errs


def test_wkv_backward_design_two_part_z_leaves_dw_little_margin():
    """Z in two parts, as every other operand, leaves dw over 8 heads of the
    path length past half its 1e-3 and twice the design's error: dw is a
    sum of terms tens of times larger than itself at some tokens, and the
    path has 256 heads (on the card the design's three parts read 4.5e-4
    there). Three keep it inside."""
    a = _inputs(44, 1, 1024, 8, 64, 64, 0.4)
    want = _reference(a, True, 32)
    errs = _errors(_model(a, True), want)
    assert _meets(errs), errs
    rel, tol = _errors(_model(a, True, parts={"Z": 2}), want)["dw"]
    assert rel > tol / 2 and rel > 2 * errs["dw"][0], (rel, errs)


def test_backward_route_geometry():
    """The reverse sweep's shared memory fits 2 blocks an SM (the path's
    256 (head, batch row) blocks in one wave on 132 SMs), its constants are
    the source's own, and the bf16 route's states (bf16 hi and lo every 32
    tokens) take half the f32 route's (one f32 state every 16 tokens) at
    the path shape."""
    import re
    mod = wkv_kernel
    assert mod.blocks_per_sm(mod.BWD_TC_SMEM_BYTES) == 2
    assert mod.blocks_per_sm(mod.BWD_TC_SMEM_BYTES) * 132 >= 4 * 64
    assert mod.BWD_TC_THREADS * 128 * 2 <= 65536       # 128 registers a thread
    text = mod.SOURCE.read_text()
    assert re.search(rf"constexpr int kBwdTcThreads = {mod.BWD_TC_THREADS};",
                     text)
    assert f"{mod.BWD_TC_SMEM_BYTES:,}" in text.split(
        "kBwdTcSmemBytes =")[1].split("\n")[0]
    assert f"__launch_bounds__(kBwdTcThreads, 2)" in text
    assert mod.backward_states_bytes(4, 1024, 64, _BF16) == 134_217_728
    assert mod.backward_states_bytes(4, 1024, 64, _F32) == 268_435_456
