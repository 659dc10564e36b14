"""The arithmetic of the Hopper scan kernels' bf16 routes, modelled in
plain PyTorch on the CPU (the kernels themselves run only on a card, in
test_torch_scan_gpu.py):

* ``ssd_scan``'s chunk: cum = cumsum(dt A), the weight G exp(cum_t -
  cum_u) dt_u formed in f32 before it meets x (which enters exact),
  exp(cum_t) applied to the f32 rows of C S^T (C enters exact), and the
  state's operand dt_u exp(total - cum_u) x_u;
* ``wkv6_scan``'s chunk: every decay a running product of w, each pair
  u < t of the chunk scored at the level (16, 8, 4, 2, 1) where the pair
  splits an aligned block, both factors decays in (0, 1), and the state's
  operand k prod_{i > t} w_i;

with every operand that is not a bf16 input split into bf16 hi + lo (hi =
bf16(f), lo = bf16(f - hi)): two products where the other operand is exact,
three (hi hi, hi lo, lo hi) where neither is. A single bf16 rounding of an
operand errs by about 2^-9 of each term; y is a sum of terms far larger
than itself (K = 64 products, a state summed over many tokens), so that
misses 2e-2 on ``|got - ref| / (1 + |ref|)``, and the final states miss
their f32 tolerances (``split=False`` models that single rounding). The
models are held against the sequential recurrences and the JAX package's Pallas
kernels in interpret mode, and the routes' launch geometry.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.kernel import ssd_scan_pallas
from repro.kernels.rwkv6_scan.kernel import wkv6_scan_pallas
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.mamba2_scan.ref import ssd_sequential
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan.ref import wkv6_sequential

torch.set_num_threads(1)

# on |got - ref| / (1 + |ref|): bf16 outputs keep ~3 significant digits;
# the final states are f32 and take tests/test_kernels.py's f32
# tolerances (SSD 3e-5, WKV 2e-4)
Y_TOL = 2e-2
SSD_STATE_TOL = 3e-5
WKV_STATE_TOL = 2e-4
_F32, _BF16 = torch.float32, torch.bfloat16


def _bf(t):
    """Round to bf16 and back to f32: one rounding point of a kernel."""
    return t.to(_BF16).to(_F32)


def _split(t):
    """f32 as bf16 hi + lo (both as f32): what the two products see."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def _x2(a, b, split=True):
    """a b with a split into hi + lo, b exact in bf16; or a rounded once."""
    return sum(part @ b for part in _split(a)) if split else _bf(a) @ b


def _x3(a, b, split=True):
    """a b with both split: hi hi + hi lo + lo hi; or each rounded once."""
    if not split:
        return _bf(a) @ _bf(b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    return float(((got - want).abs() / (1 + want.abs())).max())


def ssd_tc_model(x, dt, A, Bm, Cm, D, *, chunk=ssd_kernel.TC_CHUNK,
                 split=True):
    """ssd_scan's bf16 route: bf16 x, Bm, Cm (one group), f32 dt, A, D.
    S is padded to whole chunks with zeros (a zero dt makes a padded
    token a no-op). Returns y (bf16) and the f32 final state."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = -S % chunk
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float()[:, :, 0], (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float()[:, :, 0], (0, 0, 0, pad))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    state = torch.zeros(B, H, P, N)
    ys = []
    for c0 in range(0, S + pad, chunk):
        xc = xf[:, c0:c0 + chunk].permute(0, 2, 1, 3)           # (B,H,c,P)
        dc = dtf[:, c0:c0 + chunk].permute(0, 2, 1)             # (B,H,c)
        Bc, Cc = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]     # (B,c,N)
        cum = torch.cumsum(dc * A[None, :, None], -1)
        total = cum[..., -1:]
        G = torch.einsum("btn,bun->btu", Cc, Bc)[:, None]       # f32, exact
        rel = cum[..., :, None] - cum[..., None, :]
        L = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
        M = G * L * dc[..., None, :]
        y = torch.exp(cum)[..., None] * _x2(
            state, Cc[:, None].transpose(-1, -2), split).transpose(-1, -2)
        y = y + _x2(M, xc, split) + D[None, :, None, None] * xc
        ys.append(y)
        xw = (dc * torch.exp(total - cum))[..., None] * xc      # (B,H,c,P)
        state = torch.exp(total)[..., None] * state + _x2(
            xw.transpose(-1, -2), Bc[:, None], split)
    y = torch.cat(ys, 2)[:, :, :S].permute(0, 2, 1, 3)
    return y.to(_BF16), state


def _prod(wc, lo, hi):
    """prod of w over tokens [lo, hi) of a chunk (B, H, c, K); 1 if empty."""
    return torch.prod(wc[:, :, lo:hi], dim=2, keepdim=True)


def wkv_tc_model(r, k, v, w, u, *, chunk=wkv_kernel.TC_CHUNK,
                 levels=wkv_kernel.LEVELS, split=True):
    """wkv6_scan's bf16 route: bf16 r, k, v, f32 w, u; every decay a
    running product of w (no exp, no log, no clamp); S padded to whole
    chunks with tokens that decay by 1 and add nothing. A pair u < t of a
    chunk is scored at the level l where t lies in the upper and u in the
    lower half of an aligned 2l-token block, m its middle, as (r_t
    prod_{m <= i < t} w_i) . (k_u prod_{u < i < m} w_i); level 1 takes the
    raw r and k. Returns y (bf16) and the f32 final state."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    pad = -S % chunk

    def prep(t, value=0.0):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad),
                                    value=value)
        return t.permute(0, 2, 1, 3)                            # (B,H,S,.)

    rf, kf, vf, wf = prep(r), prep(k), prep(v), prep(w, 1.0)
    state = torch.zeros(B, H, K, V)
    ys = []
    for c0 in range(0, S + pad, chunk):
        rc, kc, vc, wc = (t[:, :, c0:c0 + chunk] for t in (rf, kf, vf, wf))
        rdec = torch.cat([rc[:, :, t:t + 1] * _prod(wc, 0, t)
                          for t in range(chunk)], 2)
        kt = torch.cat([kc[:, :, t:t + 1] * _prod(wc, t + 1, chunk)
                        for t in range(chunk)], 2)
        A = torch.diag_embed((rc * u[None, :, None] * kc).sum(-1))
        for lv in levels:
            for s0 in range(0, chunk, 2 * lv):
                m = s0 + lv
                if lv == 1:               # raw r and k, exact in bf16
                    A[:, :, m, s0] = (rc[:, :, m] * kc[:, :, s0]).sum(-1)
                    continue
                q = torch.cat([rc[:, :, t:t + 1] * _prod(wc, m, t)
                               for t in range(m, s0 + 2 * lv)], 2)
                kk = torch.cat([kc[:, :, t:t + 1] * _prod(wc, t + 1, m)
                                for t in range(s0, m)], 2)
                A[:, :, m:s0 + 2 * lv, s0:m] = _x3(q, kk.transpose(-1, -2),
                                                   split)
        ys.append(_x3(rdec, state, split) + _x2(A, vc, split))
        state = _prod(wc, 0, chunk).transpose(-1, -2) * state + _x2(
            kt.transpose(-1, -2), vc, split)
    y = torch.cat(ys, 2)[:, :, :S].permute(0, 2, 1, 3)
    return y.to(_BF16), state


def _ssd_inputs(seed, B, S, H, P, N, dt_range=(1e-3, 0.1)):
    """tests/test_kernels.py's draws, with x, Bm, Cm bf16-representable."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(torch.tensor(a).to(_BF16).float())  # noqa: E731
    return (bf(rng.normal(size=(B, S, H, P)).astype(np.float32)),
            rng.uniform(*dt_range, (B, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
            bf(rng.normal(size=(B, S, 1, N)).astype(np.float32)),
            bf(rng.normal(size=(B, S, 1, N)).astype(np.float32)),
            rng.normal(size=(H,)).astype(np.float32))


def _wkv_inputs(seed, B, S, H, K, w_range):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(torch.tensor(a).to(_BF16).float())  # noqa: E731
    r, k, v = (bf(rng.normal(size=(B, S, H, K)).astype(np.float32))
               for _ in range(3))
    w = rng.uniform(*w_range, (B, S, H, K)).astype(np.float32)
    return r, k, v, w, rng.normal(size=(H, K)).astype(np.float32)


def _ssd_args(arrs):
    x, dt, A, Bm, Cm, D = (torch.tensor(a) for a in arrs)
    return x.to(_BF16), dt, A, Bm.to(_BF16), Cm.to(_BF16), D


def _wkv_args(arrs):
    r, k, v, w, u = (torch.tensor(a) for a in arrs)
    return r.to(_BF16), k.to(_BF16), v.to(_BF16), w, u


# (B, S, H, P, N, Pallas chunk): tests/test_kernels.py's shapes, a ragged
# S (100, chunk 50) and the path's widths at a short length
SSD_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 64, 2, 8, 32, 16),
              (2, 100, 2, 64, 64, 50), (1, 192, 2, 64, 64, 64)]


@pytest.mark.parametrize("dt_range", [(1e-3, 0.1), (1.0, 5.0)],
                         ids=["mild", "strong"])   # dt |A| up to 10
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_design_matches_references(shape, dt_range):
    B, S, H, P, N, chunk = shape
    arrs = _ssd_inputs(20, B, S, H, P, N, dt_range)
    y, st = ssd_tc_model(*_ssd_args(arrs))
    assert y.dtype == _BF16 and y.shape == (B, S, H, P)
    assert st.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    want_y, want_st = ssd_sequential(*(torch.tensor(a) for a in arrs))
    jy, jst = ssd_scan_pallas(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                              interpret=True)
    for ref_y, ref_st in ((want_y, want_st), (jy, jst)):
        assert _rel(y.float(), ref_y) <= Y_TOL
        assert _rel(st, ref_st) <= SSD_STATE_TOL


def test_ssd_single_bf16_state_operand_misses_the_state_tolerance():
    """One bf16 rounding of (w_u x_u) errs by about 2^-9 a term: the final
    state then misses 3e-5, which the hi + lo split meets."""
    arrs = _ssd_inputs(21, 1, 256, 2, 64, 64)
    want = ssd_sequential(*(torch.tensor(a) for a in arrs))[1]
    single = ssd_tc_model(*_ssd_args(arrs), split=False)[1]
    split = ssd_tc_model(*_ssd_args(arrs), split=True)[1]
    assert _rel(single, want) > SSD_STATE_TOL
    assert _rel(split, want) <= SSD_STATE_TOL


# (B, S, H, K, Pallas chunk)
WKV_SHAPES = [(2, 128, 3, 16, 32), (1, 64, 2, 32, 16), (2, 100, 2, 64, 50),
              (1, 160, 2, 64, 32)]


@pytest.mark.parametrize("w_range", [(0.001, 0.999), (0.4, 0.999)],
                         ids=["aggressive", "mild"])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv_design_matches_references(shape, w_range):
    B, S, H, K, chunk = shape
    arrs = _wkv_inputs(22, B, S, H, K, w_range)
    y, st = wkv_tc_model(*_wkv_args(arrs))
    assert y.dtype == _BF16 and y.shape == (B, S, H, K)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    want_y, want_st = wkv6_sequential(*(torch.tensor(a) for a in arrs))
    jy, jst = wkv6_scan_pallas(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                               interpret=True)
    for ref_y, ref_st in ((want_y, want_st), (jy, jst)):
        assert _rel(y.float(), ref_y) <= Y_TOL
        assert _rel(st, ref_st) <= WKV_STATE_TOL


@pytest.mark.parametrize("w_value", [1e-30, 0.9999])
def test_wkv_design_exact_at_extreme_decay(w_value):
    """Every token's decay at 1e-30 (the off-diagonal factors underflow to
    0, as the true products do) or at 0.9999 (nearly none): all outputs
    finite and within tolerance of the recurrence and the Pallas kernel."""
    arrs = list(_wkv_inputs(23, 1, 96, 2, 64, (0.5, 0.5)))
    arrs[3][:] = np.float32(w_value)
    y, st = wkv_tc_model(*_wkv_args(arrs))
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    want_y, want_st = wkv6_sequential(*(torch.tensor(a) for a in arrs))
    jy, jst = wkv6_scan_pallas(*(jnp.asarray(a) for a in arrs), chunk=32,
                               interpret=True)
    assert bool(np.isfinite(np.asarray(jy)).all())
    for ref_y, ref_st in ((want_y, want_st), (jy, jst)):
        assert _rel(y.float(), ref_y) <= Y_TOL
        assert _rel(st, ref_st) <= WKV_STATE_TOL


def test_wkv_single_bf16_operands_miss_the_tolerances():
    """One bf16 rounding of each operand that is not a bf16 input misses
    2e-2 on y (a sum of terms far larger than itself) and 2e-4 on the
    final state at mild decay; the hi + lo splits meet both."""
    arrs = _wkv_inputs(24, 1, 256, 2, 64, (0.9, 0.999))
    want_y, want_st = wkv6_sequential(*(torch.tensor(a) for a in arrs))
    y1, st1 = wkv_tc_model(*_wkv_args(arrs), split=False)
    y2, st2 = wkv_tc_model(*_wkv_args(arrs), split=True)
    assert _rel(y1.float(), want_y) > Y_TOL
    assert _rel(st1, want_st) > WKV_STATE_TOL
    assert _rel(y2.float(), want_y) <= Y_TOL
    assert _rel(st2, want_st) <= WKV_STATE_TOL


@pytest.mark.parametrize("mod,blocks", [(ssd_kernel, 4 * 80),
                                        (wkv_kernel, 4 * 64)],
                         ids=["ssd_scan", "wkv6_scan"])
def test_tensor_core_route_geometry(mod, blocks):
    """One block's shared memory fits the 232,448 bytes a block may hold,
    and enough blocks are resident on the 132 SMs for the path's grid (one
    block per head and batch row) to run in one wave; the constants are
    the source's own."""
    assert mod.TC_SMEM_BYTES <= mod.MAX_SMEM_BYTES
    assert mod.blocks_per_sm() * 132 >= blocks
    text = mod.SOURCE.read_text()
    for name, value in (("kTcThreads", mod.TC_THREADS),
                        ("kTcChunk", mod.TC_CHUNK)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert f"{mod.TC_SMEM_BYTES:,}" in text.split("kTcSmemBytes =")[1]


def test_smoke_scan_cases_reach_strong_and_extreme_decay():
    """chip_smoke.py holds both routes at strong SSD decay and extreme WKV
    decay in both dtypes, against the per-token recurrences, and its decay
    draws reach 1e-30."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    strong = [c for c in smoke.SSD_CASES if c[0].startswith("strong")]
    extreme = [c for c in smoke.WKV_CASES if c[0].startswith("extreme")]
    assert {c[6] for c in strong} == {c[5] for c in extreme} \
        == {"float32", "bfloat16"}
    assert all(c[8][1] * 2.0 >= 10 for c in strong)    # dt |A| up to 10
    assert all(c[6] == 1e-30 for c in extreme)
    w = smoke._decays(torch.Generator().manual_seed(0), 1e-30, (4096,), "cpu")
    assert float(w.min()) < 1e-20 and float(w.max()) <= 0.999


def _ssd64(x, dt, A, Bm, Cm, D):
    """The SSD recurrence in float64, token by token."""
    x, dt, A, Bm, Cm, D = (torch.as_tensor(a, dtype=torch.float64)
                           for a in (x, dt, A, Bm, Cm, D))
    B, S, H, P = x.shape
    st = torch.zeros(B, H, P, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        st = torch.exp(dt[:, t] * A)[..., None, None] * st \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, 0][:, None, None]
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t, 0])
                  + D[None, :, None] * x[:, t])
    return torch.stack(ys, 1), st


def _wkv64(r, k, v, w, u):
    """The WKV recurrence in float64, token by token."""
    r, k, v, w, u = (torch.as_tensor(a, dtype=torch.float64)
                     for a in (r, k, v, w, u))
    B, S, H, K = r.shape
    st = torch.zeros(B, H, K, v.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[None, :, :, None] * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1), st


def test_plain_chunked_forms_lose_f32_digits_at_strong_decay():
    """At strong decay the chunked forms take exp of differences of large
    cumulative decays; in f32 (the Pallas kernels' own form) those lose
    digits and missed a float64 recurrence by more than the f32
    tolerances (SSD at dt up to 5: 3e-5; WKV at w down to 1e-30: 2e-4).
    The plain chunked forms (the CPU route and the chip smoke's usual
    yardstick) compute in float64 and cast back, so they now stay inside
    those tolerances, as the f32 per-token recurrences do; the kernels are
    held against the per-token recurrences at those decays as well."""
    from repro_torch.kernels.mamba2_scan.ref import ssd_chunked
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked
    arrs = _ssd_inputs(25, 1, 256, 4, 64, 64, (1.0, 5.0))
    want, want_state = _ssd64(*arrs)
    ts = [torch.tensor(a) for a in arrs]
    y, state = ssd_chunked(*ts, chunk=64)
    assert y.dtype == state.dtype == torch.float32
    assert _rel(y, want) <= SSD_STATE_TOL
    assert _rel(state, want_state) <= SSD_STATE_TOL
    assert _rel(ssd_sequential(*ts)[0], want) <= SSD_STATE_TOL
    arrs = list(_wkv_inputs(26, 1, 128, 2, 64, (0.5, 0.5)))
    rng = np.random.default_rng(26)
    arrs[3] = np.exp(rng.uniform(np.log(1e-30), np.log(0.999),
                                 arrs[3].shape)).astype(np.float32)
    want, want_state = _wkv64(*arrs)
    ts = [torch.tensor(a) for a in arrs]
    y, state = wkv6_chunked(*ts, chunk=32)
    assert y.dtype == state.dtype == torch.float32
    assert _rel(y, want) <= WKV_STATE_TOL
    assert _rel(state, want_state) <= WKV_STATE_TOL
    assert _rel(wkv6_sequential(*ts)[0], want) <= WKV_STATE_TOL
