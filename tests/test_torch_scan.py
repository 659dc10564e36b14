"""The port's Mamba2 SSD and RWKV6 WKV scans against the JAX package's, on
the CPU: the plain versions against the Pallas kernels (interpret mode),
the reference's XLA chunked forms and sequential recurrences, at
tests/test_kernels.py's shapes and tolerances; continuation from an
initial state; the one-token decode steps; the ops' shape checks and the
CUDA wrappers' checks, which all raise before anything is built; the
mixers of arch/mamba2.py and arch/rwkv6.py against their JAX twins."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import mamba2 as JMB
from repro.arch import model as JM
from repro.arch import rwkv6 as JRW
from repro.configs import get_config as jax_get_config
from repro.kernels.mamba2_scan import ref as jssd
from repro.kernels.mamba2_scan.kernel import ssd_scan_pallas
from repro.kernels.rwkv6_scan import ref as jwkv
from repro.kernels.rwkv6_scan.kernel import wkv6_scan_pallas
from repro_torch.arch import mamba2 as TMB
from repro_torch.arch import rwkv6 as TRW
from repro_torch.arch.params import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan import ref as tssd
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as twkv

torch.set_num_threads(1)

# tests/test_kernels.py's tolerances: the SSD's chunked and sequential f32
# sums agree to 3e-5; the WKV's decay products over a chunk to 2e-4
SSD_TOL = 3e-5
WKV_TOL = 2e-4
SSD_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 64, 2, 8, 32, 16),
              (1, 96, 1, 32, 16, 32)]
WKV_SHAPES = [(2, 128, 3, 16, 32), (1, 64, 2, 32, 16)]


def _ssd_inputs(seed, B, S, H, P, N, G=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32))


def _wkv_inputs(seed, B, S, H, K, wmin):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(wmin, 0.999, (B, S, H, K)).astype(np.float32)
    return r, k, v, w, rng.normal(size=(H, K)).astype(np.float32)


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------- SSD

@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_plain_ssd_matches_jax(B, S, H, P, N, chunk):
    """The plain chunked SSD against the Pallas kernel (interpret mode),
    the reference's chunked form and its sequential recurrence; the port's
    sequential recurrence against the same."""
    arrs = _ssd_inputs(0, B, S, H, P, N)
    y, st = tssd.ssd_chunked(*_t(arrs), chunk=chunk)
    for want_y, want_st in (
            ssd_scan_pallas(*_j(arrs), chunk=chunk, interpret=True),
            jssd.ssd_chunked(*_j(arrs), chunk=chunk),
            jssd.ssd_sequential(*_j(arrs))):
        _close(y, want_y, SSD_TOL)
        _close(st, want_st, SSD_TOL)
    sy, sst = tssd.ssd_sequential(*_t(arrs))
    _close(sy, want_y, SSD_TOL)
    _close(sst, want_st, SSD_TOL)


def test_plain_ssd_continues_from_init_state():
    """Two halves, the second from the first's final state, equal one
    pass over the whole sequence (tests/test_kernels.py's check of the
    reference's XLA path), and the reference's own continuation."""
    B, S, H, P, N = 1, 128, 2, 8, 8
    arrs = _ssd_inputs(1, B, S, H, P, N)
    x, dt, A, Bm, Cm, D = _t(arrs)
    y_full, s_full = jssd.ssd_sequential(*_j(arrs))
    h = S // 2
    _, s1 = tssd.ssd_chunked(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], D,
                             chunk=32)
    y2, s2 = tssd.ssd_chunked(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], D,
                              s1, chunk=32)
    _close(y2, np.asarray(y_full)[:, h:], SSD_TOL)
    _close(s2, s_full, SSD_TOL)
    # the op's CPU route honours init_state the same way
    y3, s3 = ssd_ops.ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], D,
                              s1, chunk=32)
    assert torch.equal(y3, y2) and torch.equal(s3, s2)
    js1 = jnp.asarray(s1.numpy())
    jy2, js2 = jssd.ssd_chunked(*_j((a[:, h:] for a in arrs[:2])), arrs[2],
                                *_j((a[:, h:] for a in arrs[3:5])), arrs[5],
                                init_state=js1, chunk=32)
    _close(y2, jy2, SSD_TOL)
    _close(s2, js2, SSD_TOL)


def test_plain_ssd_groups_match_jax():
    """The plain versions expand groups over heads as the reference does
    (the op itself takes one group)."""
    arrs = _ssd_inputs(2, 1, 64, 4, 8, 16, G=2)
    y, st = tssd.ssd_chunked(*_t(arrs), chunk=32)
    want_y, want_st = jssd.ssd_chunked(*_j(arrs), chunk=32)
    _close(y, want_y, SSD_TOL)
    _close(st, want_st, SSD_TOL)
    sy, _ = tssd.ssd_sequential(*_t(arrs))
    _close(sy, want_y, SSD_TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    B, H, P, N = 2, 3, 8, 16
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (B, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, 1, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    arrs = (state, x, dt, A, Bm, Cm, D)
    y, st = tssd.ssd_decode_step(*_t(arrs))
    want_y, want_st = jssd.ssd_decode_step(*_j(arrs))
    _close(y, want_y, 1e-6)
    _close(st, want_st, 1e-6)


def test_ssd_op_counts_and_routes_to_the_plain_version_on_cpu():
    arrs = _t(_ssd_inputs(4, 2, 128, 3, 16, 16))
    before = ssd_ops.invocation_count()
    y, st = ssd_ops.ssd_scan(*arrs)                 # chunk min(64, S) = 64
    assert ssd_ops.invocation_count() == before + 1
    want_y, want_st = tssd.ssd_chunked(*arrs, chunk=64)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert st.dtype == torch.float32
    half = [a.to(torch.bfloat16) if a.dim() == 4 else a for a in arrs]
    assert ssd_ops.ssd_scan(*half)[0].dtype == torch.bfloat16
    ssd_ops.reset_invocation_count()
    assert ssd_ops.invocation_count() == 0


def _ssd_bad(case):
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs(5, 1, 64, 2, 8, 16))
    kw = {}
    if case == "groups":
        Bm = Cm = torch.zeros(1, 64, 2, 16)
    elif case == "ragged":
        x, dt, Bm, Cm = x[:, :48], dt[:, :48], Bm[:, :48], Cm[:, :48]
    elif case == "dt":
        dt = dt[..., :1]
    elif case == "init_state":
        kw["init_state"] = torch.zeros(1, 2, 8, 8)
    return (x, dt, A, Bm, Cm, D), kw


@pytest.mark.parametrize("case,match", [
    ("groups", "one group"), ("ragged", "not a multiple of the chunk"),
    ("dt", "dt must be"), ("init_state", "init_state must be")])
def test_ssd_op_rejects_bad_shapes(case, match):
    args, kw = _ssd_bad(case)
    before = ssd_ops.invocation_count()
    with pytest.raises(ValueError, match=match):
        ssd_ops.ssd_scan(*args, chunk=32, **kw)
    assert ssd_ops.invocation_count() == before


def _no_build(monkeypatch, module):
    def refuse():
        raise AssertionError("the library was asked for before the checks")
    monkeypatch.setattr(module, "_library", refuse)


@pytest.mark.parametrize("case,exc,match", [
    ("init_state", ValueError, "zero state"),
    ("groups", ValueError, "one group"),
    ("x_int", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "Bm in torch.bfloat16"),
    ("dt_half", TypeError, "dt in torch.float32"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_ssd_kernel_path_checks_before_build(monkeypatch, case, exc, match):
    """The CUDA wrapper refuses what the kernel does not take before the
    library is built or loaded (here, with no nvcc, it would fail)."""
    _no_build(monkeypatch, ssd_kernel)
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs(6, 1, 64, 2, 8, 16))
    init = None
    if case == "init_state":
        init = torch.ones(1, 2, 8, 16)
    elif case == "groups":
        Bm = torch.zeros(1, 64, 2, 16)
    elif case == "x_int":
        x = x.to(torch.int32)
    elif case == "mixed":
        x = x.to(torch.bfloat16)
    elif case == "dt_half":
        dt = dt.to(torch.bfloat16)
    with pytest.raises(exc, match=match):
        ssd_kernel.ssd_scan_cuda(x, dt, A, Bm, Cm, D, init)


@pytest.mark.parametrize("P,N,ok", [(64, 64, True), (8, 16, True),
                                    (65, 64, False), (64, 8, False),
                                    (16, 24, False), (16, 80, False)])
def test_ssd_kernel_geometry(P, N, ok):
    if ok:
        ssd_kernel.check_launch(P, N)
    else:
        with pytest.raises(ValueError):
            ssd_kernel.check_launch(P, N)


def test_kernel_sources_declare_the_wrappers_geometry():
    """The constants the wrappers check at load time are the sources' own
    (the check at load needs a card; this reads the text)."""
    text = ssd_kernel.SOURCE.read_text()
    for name, value in (("kThreads", ssd_kernel.THREADS),
                        ("kLanesPerRow", ssd_kernel.LANES_PER_ROW),
                        ("kMaxN", ssd_kernel.MAX_N),
                        ("kTokens", ssd_kernel.TOKENS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert ssd_kernel.MAX_P == ssd_kernel.THREADS // ssd_kernel.LANES_PER_ROW
    text = wkv_kernel.SOURCE.read_text()
    for name, value in (("kThreads", wkv_kernel.THREADS),
                        ("kLanesPerCol", wkv_kernel.LANES_PER_COL),
                        ("kMaxK", wkv_kernel.MAX_K),
                        ("kTokens", wkv_kernel.TOKENS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert wkv_kernel.MAX_V == wkv_kernel.THREADS // wkv_kernel.LANES_PER_COL


# ---------------------------------------------------------------- WKV6

@pytest.mark.parametrize("wmin", [0.4, 0.001])       # mild + aggressive decay
@pytest.mark.parametrize("B,S,H,K,chunk", WKV_SHAPES)
def test_plain_wkv6_matches_jax(wmin, B, S, H, K, chunk):
    """The plain chunked WKV (exact masked decay) against the Pallas kernel
    (interpret mode) and the sequential recurrence, at both decays; the
    port's sequential recurrence against the same."""
    arrs = _wkv_inputs(7, B, S, H, K, wmin)
    y, st = twkv.wkv6_chunked(*_t(arrs), chunk=chunk)
    for want_y, want_st in (
            wkv6_scan_pallas(*_j(arrs), chunk=chunk, interpret=True),
            jwkv.wkv6_sequential(*_j(arrs))):
        _close(y, want_y, WKV_TOL)
        _close(st, want_st, WKV_TOL)
    sy, sst = twkv.wkv6_sequential(*_t(arrs))
    _close(sy, want_y, WKV_TOL)
    _close(sst, want_st, WKV_TOL)


def test_plain_wkv6_matches_xla_chunked_at_moderate_decay():
    """The reference's XLA chunked form clamps exp(-cum) at 80, so it is
    held only where tests/test_kernels.py holds it: w >= 0.37."""
    arrs = _wkv_inputs(8, 2, 96, 2, 16, 0.37)
    y, st = twkv.wkv6_chunked(*_t(arrs), chunk=32)
    want_y, want_st = jwkv.wkv6_chunked(*_j(arrs), chunk=32)
    _close(y, want_y, WKV_TOL)
    _close(st, want_st, WKV_TOL)


def test_plain_wkv6_exact_where_the_clamp_departs():
    """At a decay strong enough that the reference's XLA form clamps, the
    plain chunked form still equals the sequential recurrence."""
    arrs = _wkv_inputs(9, 1, 64, 2, 16, 0.001)
    w = arrs[3]
    w[:] = np.float32(0.01)                  # -cum reaches 32 * 4.6 > 80
    y, st = twkv.wkv6_chunked(*_t(arrs), chunk=32)
    want_y, want_st = jwkv.wkv6_sequential(*_j(arrs))
    _close(y, want_y, WKV_TOL)
    _close(st, want_st, WKV_TOL)
    clamped, _ = jwkv.wkv6_chunked(*_j(arrs), chunk=32)
    assert not np.allclose(np.asarray(clamped), np.asarray(want_y),
                           atol=WKV_TOL, rtol=WKV_TOL)


def test_plain_wkv6_continues_from_init_state():
    B, S, H, K = 1, 128, 2, 16
    arrs = _wkv_inputs(10, B, S, H, K, 0.4)
    r, k, v, w, u = _t(arrs)
    y_full, s_full = jwkv.wkv6_sequential(*_j(arrs))
    h = S // 2
    _, s1 = twkv.wkv6_chunked(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u,
                              chunk=32)
    y2, s2 = wkv_ops.wkv6_scan(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    _close(y2, np.asarray(y_full)[:, h:], WKV_TOL)
    _close(s2, s_full, WKV_TOL)


def test_wkv6_decode_step_matches_jax():
    rng = np.random.default_rng(11)
    B, H, K = 2, 3, 16
    state = rng.normal(size=(B, H, K, K)).astype(np.float32)
    r, k, v = (rng.normal(size=(B, H, K)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.001, 0.999, (B, H, K)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    arrs = (state, r, k, v, w, u)
    y, st = twkv.wkv6_decode_step(*_t(arrs))
    want_y, want_st = jwkv.wkv6_decode_step(*_j(arrs))
    _close(y, want_y, 1e-6)
    _close(st, want_st, 1e-6)


def test_wkv6_op_counts_and_routes_to_the_plain_version_on_cpu():
    arrs = _t(_wkv_inputs(12, 2, 64, 2, 16, 0.4))
    before = wkv_ops.invocation_count()
    y, st = wkv_ops.wkv6_scan(*arrs)                # chunk min(32, S) = 32
    assert wkv_ops.invocation_count() == before + 1
    want_y, want_st = twkv.wkv6_chunked(*arrs, chunk=32)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    r, k, v, w, u = arrs
    half = [t.to(torch.bfloat16) for t in (r, k, v)]
    y, st = wkv_ops.wkv6_scan(*half, w, u)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    wkv_ops.reset_invocation_count()
    assert wkv_ops.invocation_count() == 0


@pytest.mark.parametrize("case,match", [
    ("ragged", "not a multiple of the chunk"), ("w", "w must be"),
    ("u", "u must be"), ("init_state", "init_state must be")])
def test_wkv6_op_rejects_bad_shapes(case, match):
    r, k, v, w, u = _t(_wkv_inputs(13, 1, 64, 2, 16, 0.4))
    kw = {}
    if case == "ragged":
        r, k, v, w = (t[:, :40] for t in (r, k, v, w))
    elif case == "w":
        w = w[..., :8]
    elif case == "u":
        u = u[:1]
    elif case == "init_state":
        kw["init_state"] = torch.zeros(1, 2, 16, 8)
    before = wkv_ops.invocation_count()
    with pytest.raises(ValueError, match=match):
        wkv_ops.wkv6_scan(r, k, v, w, u, chunk=32, **kw)
    assert wkv_ops.invocation_count() == before


@pytest.mark.parametrize("case,exc,match", [
    ("init_state", ValueError, "zero state"),
    ("w_half", TypeError, "w in torch.float32"),
    ("mixed", TypeError, "k in torch.bfloat16"),
    ("r_int", TypeError, "float32 or bfloat16"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_wkv6_kernel_path_checks_before_build(monkeypatch, case, exc, match):
    _no_build(monkeypatch, wkv_kernel)
    r, k, v, w, u = _t(_wkv_inputs(14, 1, 64, 2, 16, 0.4))
    init = None
    if case == "init_state":
        init = torch.ones(1, 2, 16, 16)
    elif case == "w_half":
        w = w.to(torch.bfloat16)
    elif case == "mixed":
        r = r.to(torch.bfloat16)
    elif case == "r_int":
        r = r.to(torch.int32)
    with pytest.raises(exc, match=match):
        wkv_kernel.wkv6_scan_cuda(r, k, v, w, u, init)


@pytest.mark.parametrize("K,V,ok", [(64, 64, True), (16, 16, True),
                                    (16, 1, True), (24, 24, False),
                                    (80, 64, False), (64, 65, False)])
def test_wkv6_kernel_geometry(K, V, ok):
    if ok:
        wkv_kernel.check_launch(K, V)
    else:
        with pytest.raises(ValueError):
            wkv_kernel.check_launch(K, V)


# ---------------------------------------------------------------- mixers

def _layer(arch, key, dtype):
    """One period-0 block's parameters of an arch's smoke config, the same
    values on both sides."""
    jcfg = jax_get_config(arch + "-smoke").replace(dtype=dtype)
    tcfg = get_config(arch + "-smoke").replace(dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"][key])
    tl = {k: v[0] for k, v in tp["blocks"]["pos0"][key].items()}
    return jcfg, tcfg, jl, tl


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_mamba2_block_and_decode_match_jax(dtype, tol):
    """Full-sequence block (from zero and continuing from a state), its
    pre-activation conv tail, and the one-token decode."""
    jcfg, tcfg, jl, tl = _layer("zamba2-2.7b", "mixer", dtype)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.tensor(x).to(getattr(torch, dtype))
    jo, (jc, js) = JMB.mamba2_block(jcfg, jl, jx)
    to, (tc, ts) = TMB.mamba2_block(tcfg, tl, tx)
    assert tc.shape == (2, tcfg.ssm_conv - 1, tc.shape[-1])
    assert ts.dtype == torch.float32 and to.dtype == tx.dtype
    for got, want in ((to, jo), (tc, jc), (ts, js)):
        assert _rel(got, want) < tol
    jo2, (_, js2) = JMB.mamba2_block(jcfg, jl, jx, init_state=js)
    to2, (_, ts2) = TMB.mamba2_block(tcfg, tl, tx, init_state=ts)
    assert _rel(to2, jo2) < tol and _rel(ts2, js2) < tol
    jd, (jc1, js1) = JMB.mamba2_decode(jcfg, jl, jx[:, :1], (jc, js))
    td, (tc1, ts1) = TMB.mamba2_decode(tcfg, tl, tx[:, :1], (tc, ts))
    for got, want in ((td, jd), (tc1, jc1), (ts1, js1)):
        assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_rwkv6_mixers_match_jax(dtype, tol):
    """Time-mix (decay in f32, y back in r's dtype), its decode twin and
    channel-mix."""
    jcfg, tcfg, jtm, ttm = _layer("rwkv6-7b", "tm", dtype)
    _, _, jcm, tcm = _layer("rwkv6-7b", "cm", dtype)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    xp = rng.normal(size=(2, tcfg.d_model)).astype(np.float32)
    cast = lambda a: (jnp.asarray(a).astype(dtype),  # noqa: E731
                      torch.tensor(a).to(getattr(torch, dtype)))
    (jx, tx), (jxp, txp) = cast(x), cast(xp)
    assert TRW._decay(ttm, tx).dtype == torch.float32
    jo, jlast, jst = JRW.timemix_block(jcfg, jtm, jx, jxp)
    to, tlast, tst = TRW.timemix_block(tcfg, ttm, tx, txp)
    assert to.dtype == tx.dtype and tst.dtype == torch.float32
    for got, want in ((to, jo), (tlast, jlast), (tst, jst)):
        assert _rel(got, want) < tol
    jd, _, jst1 = JRW.timemix_decode(jcfg, jtm, jx[:, :1], jxp, jst)
    td, _, tst1 = TRW.timemix_decode(tcfg, ttm, tx[:, :1], txp, tst)
    assert _rel(td, jd) < tol and _rel(tst1, jst1) < tol
    jc, _ = JRW.channelmix_block(jcfg, jcm, jx, jxp)
    tc, _ = TRW.channelmix_block(tcfg, tcm, tx, txp)
    assert _rel(tc, jc) < tol
