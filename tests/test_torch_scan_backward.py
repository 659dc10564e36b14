"""The gradients of the port's Mamba2 SSD and RWKV6 WKV scans on the CPU.

The plain backwards (``ssd_backward_reference``, ``wkv6_backward_reference``:
the CPU route of the ops under autograd and the yardsticks of the CUDA
backward kernels) against ``torch.autograd`` through the port's plain
chunked forms and through float64 per-token recurrences written here, and
against ``jax.vjp`` of the JAX package's ``ssd_chunked`` / ``ssd_sequential``
and ``wkv6_chunked`` / ``wkv6_sequential`` (what ``jax.grad`` differentiates
on the reference's training path: no Pallas kernel defines a VJP), with and
without an initial state and a final-state gradient, at mild and strong
decay. Then the ops' gradients under autograd against ``jax.grad``, the
backward wrappers' checks (they raise before anything is built), the
planted faults the card's tolerance must catch, and a CPU rehearsal of
``chip_smoke.py``'s scan-backward phase. Inputs are drawn with numpy and
handed to both packages.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import ref as jssd
from repro.kernels.rwkv6_scan import ref as jwkv
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan import ref as tssd
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as twkv

torch.set_num_threads(1)

# on |got - ref| / (1 + |ref|):
# float64 against float64 autograd: the same sums in other orders
F64_TOL = 1e-10
# the port's chunked forms keep a state in f32 where it enters (init_state)
# and leaves (final_state), so a gradient through either carries one f32
# rounding of the state (about 1e-7 relative)
F32_STATE_TOL = 1e-5
# the JAX package computes in f32 (XLA's sums and exponentials) against the
# float64 backwards here: up to 1.3e-5 at these sizes
JAX_TOL = 1e-4
# the card's tolerances for the backward kernels (chip_smoke.SCAN_BWD_TOL):
# a planted fault must exceed both
CARD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}

SSD_SHAPES = [(2, 64, 3, 8, 16, 16), (1, 96, 2, 16, 32, 32)]
WKV_SHAPES = [(2, 64, 3, 16, 16), (1, 96, 2, 32, 32)]
SSD_MILD, SSD_STRONG = (1e-3, 0.1), (1.0, 5.0)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _ssd_arrays(seed, B, S, H, P, N, dt_range=SSD_MILD):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(B, S, H, P)).astype(f),
        dt=rng.uniform(*dt_range, (B, S, H)).astype(f),
        A=(-rng.uniform(0.5, 2.0, (H,))).astype(f),
        Bm=rng.normal(size=(B, S, 1, N)).astype(f),
        Cm=rng.normal(size=(B, S, 1, N)).astype(f),
        D=rng.normal(size=(H,)).astype(f),
        init=rng.normal(size=(B, H, P, N)).astype(f),
        dy=rng.normal(size=(B, S, H, P)).astype(f),
        dF=rng.normal(size=(B, H, P, N)).astype(f))


def _wkv_arrays(seed, B, S, H, K, wmin):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v, dy = (rng.normal(size=(B, S, H, K)).astype(f) for _ in range(4))
    if wmin >= 1e-6:
        w = rng.uniform(wmin, 0.999, (B, S, H, K))
    else:   # log-uniform, so decays near wmin occur
        w = np.exp(rng.uniform(np.log(wmin), np.log(0.999), (B, S, H, K)))
    return dict(r=r, k=k, v=v, w=w.astype(f),
                u=rng.normal(size=(H, K)).astype(f),
                init=rng.normal(size=(B, H, K, K)).astype(f), dy=dy,
                dF=rng.normal(size=(B, H, K, K)).astype(f))


SSD_IN = ("x", "dt", "A", "Bm", "Cm", "D")
WKV_IN = ("r", "k", "v", "w", "u")


def _ssd_ref(a, init, dF, chunk, dtype=torch.float32):
    t = {n: torch.tensor(v, dtype=dtype) for n, v in a.items()}
    return tssd.ssd_backward_reference(
        *(t[n] for n in SSD_IN), t["dy"], t["init"] if init else None,
        t["dF"] if dF else None, chunk=chunk)


def _wkv_ref(a, init, dF, chunk, dtype=torch.float32):
    t = {n: torch.tensor(v, dtype=dtype) for n, v in a.items()}
    return twkv.wkv6_backward_reference(
        *(t[n] for n in WKV_IN), t["dy"], t["init"] if init else None,
        t["dF"] if dF else None, chunk=chunk)


def _ssd_seq64(x, dt, A, Bm, Cm, D, s0):
    """The SSD recurrence token by token in float64 (ground truth)."""
    B, S, H, P = x.shape
    state = torch.zeros(B, H, P, Bm.shape[-1], dtype=torch.float64) \
        if s0 is None else s0
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)[..., None, None]
        state = a * state + (dt[:, t, :, None] * x[:, t])[..., None] \
            * Bm[:, t, 0, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t, 0])
                  + D[:, None] * x[:, t])
    return torch.stack(ys, 1), state


def _wkv_seq64(r, k, v, w, u, s0):
    """The WKV recurrence token by token in float64 (ground truth)."""
    B, S, H, K = r.shape
    state = torch.zeros(B, H, K, v.shape[-1], dtype=torch.float64) \
        if s0 is None else s0
    ys = []
    for t in range(S):
        kv = k[:, t, ..., None] * v[:, t, :, None]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, ..., None] * state + kv
    return torch.stack(ys, 1), state


def _autograd(fn, a, names, init, dF):
    """Gradients of sum(y dy) + sum(final dF) through ``fn`` in float64."""
    leaves = [torch.tensor(a[n], dtype=torch.float64, requires_grad=True)
              for n in names + (("init",) if init else ())]
    y, final = fn(*leaves[:len(names)], leaves[-1] if init else None)
    loss = torch.sum(y.double() * torch.tensor(a["dy"], dtype=torch.float64))
    if dF:
        loss = loss + torch.sum(final.double()
                                * torch.tensor(a["dF"], dtype=torch.float64))
    return torch.autograd.grad(loss, leaves)


# ------------------------------------------------ the plain backwards

@pytest.mark.parametrize("init,dF", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_backward_reference_matches_autograd_of_the_chunked_form(
        shape, init, dF):
    *dims, chunk = shape
    a = _ssd_arrays(1, *dims)
    want = _autograd(lambda *t: tssd.ssd_chunked(*t, chunk=chunk), a,
                     SSD_IN, init, dF)
    got = [g for g in _ssd_ref(a, init, dF, chunk, torch.float64)
           if g is not None]
    tol = F32_STATE_TOL if init or dF else F64_TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("dt_range", [SSD_MILD, SSD_STRONG])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_backward_reference_matches_a_float64_recurrence(shape,
                                                             dt_range):
    """At mild and strong decay (dt |A| up to 10), with an initial state
    and a final-state gradient: the backward forms states, never divides
    a decay out, so strong decay costs no digits."""
    *dims, chunk = shape
    a = _ssd_arrays(2, *dims, dt_range=dt_range)
    want = _autograd(
        lambda x, dt, A, Bm, Cm, D, s0: _ssd_seq64(x, dt, A, Bm, Cm, D, s0),
        a, SSD_IN, True, True)
    got = _ssd_ref(a, True, True, chunk, torch.float64)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F64_TOL


@pytest.mark.parametrize("init,dF", [(False, False), (True, True)])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_backward_reference_matches_autograd_of_the_chunked_form(
        shape, init, dF):
    """At w >= 0.4: autograd of the chunked form differentiates log w and
    divides by w, exact only where w is moderate."""
    *dims, chunk = shape
    a = _wkv_arrays(3, *dims, 0.4)
    want = _autograd(lambda *t: twkv.wkv6_chunked(*t, chunk=chunk), a,
                     WKV_IN, init, dF)
    got = [g for g in _wkv_ref(a, init, dF, chunk, torch.float64)
           if g is not None]
    tol = F32_STATE_TOL if init or dF else F64_TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("wmin", [0.4, 1e-3, 1e-30])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_backward_reference_matches_a_float64_recurrence(shape, wmin):
    """Down to w near 1e-30: dw comes from the product of the state and
    its adjoint, never as d(log w) / w."""
    *dims, chunk = shape
    a = _wkv_arrays(4, *dims, wmin)
    want = _autograd(_wkv_seq64, a, WKV_IN, True, True)
    got = _wkv_ref(a, True, True, chunk, torch.float64)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F64_TOL


def _jax_vjp(fn, a, names, init, dF):
    args = [jnp.asarray(a[n]) for n in names]
    if init:
        args.append(jnp.asarray(a["init"]))
    y, vjp = jax.vjp(fn, *args)
    cot = (jnp.asarray(a["dy"]), jnp.asarray(a["dF"]) if dF
           else jnp.zeros_like(y[1]))
    return vjp(cot)


@pytest.mark.parametrize("form,dt_range", [("chunked", SSD_MILD),
                                           ("sequential", SSD_MILD),
                                           ("sequential", SSD_STRONG)])
@pytest.mark.parametrize("init,dF", [(False, False), (True, True)])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_backward_reference_matches_jax_grad(shape, init, dF, form,
                                                 dt_range):
    """Against jax.vjp of the JAX package's forms in f32. Its chunked form
    only at mild decay: at strong decay its masked exponentials overflow
    and its dt gradient is NaN (the sequential form holds)."""
    *dims, chunk = shape
    a = _ssd_arrays(5, *dims, dt_range=dt_range)
    fn = (lambda *t: jssd.ssd_chunked(*t, chunk=chunk)) \
        if form == "chunked" else jssd.ssd_sequential
    want = _jax_vjp(fn, a, SSD_IN, init, dF)
    got = [g for g in _ssd_ref(a, init, dF, chunk) if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= JAX_TOL


@pytest.mark.parametrize("form,wmin", [("chunked", 0.4),
                                       ("sequential", 0.4),
                                       ("sequential", 1e-3),
                                       ("sequential", 1e-30)])
@pytest.mark.parametrize("init,dF", [(False, False), (True, True)])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_backward_reference_matches_jax_grad(shape, init, dF, form,
                                                  wmin):
    """Against jax.vjp of the JAX package's forms in f32. Its chunked form
    only at w >= 0.37: it clamps exp(-cum) at exp(80) (ref.py:64-68), and
    d(log w) / w loses its digits at small w; strong decay against the
    sequential form."""
    *dims, chunk = shape
    a = _wkv_arrays(6, *dims, wmin)
    fn = (lambda *t: jwkv.wkv6_chunked(*t, chunk=chunk)) \
        if form == "chunked" else jwkv.wkv6_sequential
    want = _jax_vjp(fn, a, WKV_IN, init, dF)
    got = [g for g in _wkv_ref(a, init, dF, chunk) if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= JAX_TOL


def test_backward_references_return_the_inputs_dtypes():
    a = _ssd_arrays(7, 1, 32, 2, 8, 16)
    t = {n: torch.tensor(v) for n, v in a.items()}
    bf = {n: t[n].to(torch.bfloat16) if n in ("x", "Bm", "Cm", "dy") else t[n]
          for n in t}
    grads = tssd.ssd_backward_reference(*(bf[n] for n in SSD_IN), bf["dy"],
                                        chunk=16)
    assert [g.dtype for g in grads[:6]] == [torch.bfloat16, torch.float32,
                                            torch.float32, torch.bfloat16,
                                            torch.bfloat16, torch.float32]
    assert grads[6] is None
    a = _wkv_arrays(7, 1, 32, 2, 16, 0.4)
    t = {n: torch.tensor(v) for n, v in a.items()}
    bf = {n: t[n].to(torch.bfloat16) if n in ("r", "k", "v", "dy") else t[n]
          for n in t}
    grads = twkv.wkv6_backward_reference(*(bf[n] for n in WKV_IN), bf["dy"],
                                         bf["init"], chunk=16)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [
        torch.float32] * 3


# ------------------------------------------------ the ops under autograd

@pytest.mark.parametrize("init", [False, True])
def test_ssd_op_gradients_match_jax_grad(init):
    """``ssd_scan`` under autograd on CPU tensors (the plain backward)
    against jax.vjp of the JAX package's chunked form; one forward and one
    backward counted."""
    B, S, H, P, N, chunk = 2, 64, 3, 8, 16, 32
    a = _ssd_arrays(8, B, S, H, P, N)
    names = SSD_IN + (("init",) if init else ())
    leaves = [torch.tensor(a[n], requires_grad=True) for n in names]
    ssd_ops.reset_invocation_count()
    y, final = ssd_ops.ssd_scan(*leaves[:6], leaves[6] if init else None,
                                chunk=chunk)
    loss = torch.sum(y * torch.tensor(a["dy"])) \
        + torch.sum(final * torch.tensor(a["dF"]))
    got = torch.autograd.grad(loss, leaves)
    assert (ssd_ops.invocation_count(),
            ssd_ops.backward_invocation_count()) == (1, 1)
    want = _jax_vjp(lambda *t: jssd.ssd_chunked(*t, chunk=chunk), a, SSD_IN,
                    init, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= JAX_TOL


@pytest.mark.parametrize("init", [False, True])
def test_wkv6_op_gradients_match_jax_grad(init):
    B, S, H, K, chunk = 2, 64, 3, 16, 16
    a = _wkv_arrays(9, B, S, H, K, 0.4)
    names = WKV_IN + (("init",) if init else ())
    leaves = [torch.tensor(a[n], requires_grad=True) for n in names]
    wkv_ops.reset_invocation_count()
    y, final = wkv_ops.wkv6_scan(*leaves[:5], leaves[5] if init else None,
                                 chunk=chunk)
    loss = torch.sum(y * torch.tensor(a["dy"])) \
        + torch.sum(final * torch.tensor(a["dF"]))
    got = torch.autograd.grad(loss, leaves)
    assert (wkv_ops.invocation_count(),
            wkv_ops.backward_invocation_count()) == (1, 1)
    want = _jax_vjp(lambda *t: jwkv.wkv6_chunked(*t, chunk=chunk), a, WKV_IN,
                    init, True)
    for g, w in zip(got, want):
        assert _rel(g, w) <= JAX_TOL


@pytest.mark.parametrize("use", ["y", "final"])
def test_scan_ops_take_either_output_alone(use):
    """A gradient of y alone or of the final state alone reaches the
    inputs (autograd hands the backward None for the unused output)."""
    a = _ssd_arrays(10, 1, 32, 2, 8, 16)
    leaves = [torch.tensor(a[n], requires_grad=True) for n in SSD_IN]
    out = ssd_ops.ssd_scan(*leaves, chunk=16)
    grads = torch.autograd.grad(out[0 if use == "y" else 1].sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    a = _wkv_arrays(10, 1, 32, 2, 16, 0.4)
    leaves = [torch.tensor(a[n], requires_grad=True) for n in WKV_IN]
    out = wkv_ops.wkv6_scan(*leaves, chunk=16)
    grads = torch.autograd.grad(out[0 if use == "y" else 1].sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_scan_ops_save_nothing_without_gradients():
    """Without an input that needs its gradient the forward keeps no
    tensors, and the outputs carry no graph."""
    a = _ssd_arrays(11, 1, 32, 2, 8, 16)
    y, final = ssd_ops.ssd_scan(*(torch.tensor(a[n]) for n in SSD_IN),
                                chunk=16)
    assert y.grad_fn is None and final.grad_fn is None
    a = _wkv_arrays(11, 1, 32, 2, 16, 0.4)
    y, final = wkv_ops.wkv6_scan(*(torch.tensor(a[n]) for n in WKV_IN),
                                 chunk=16)
    assert y.grad_fn is None and final.grad_fn is None


# ------------------------------------------------ the CUDA wrappers' checks

def _no_build(monkeypatch, module):
    def refuse():
        raise AssertionError("the library was asked for before the checks")
    monkeypatch.setattr(module, "_library", refuse)


@pytest.mark.parametrize("case,exc,match", [
    ("x_half", TypeError, "float32 or bfloat16"),
    ("dt_bf16", TypeError, "dt in torch.float32"),
    ("groups", ValueError, "one group"),
    ("dy_dtype", ValueError, "dy like x"),
    ("dy_shape", ValueError, "dy like x"),
    ("dF_shape", ValueError, "d_final_state"),
    ("dF_dtype", ValueError, "d_final_state"),
    ("cpu", ValueError, "CUDA tensors"),
    ("Cm_mixed", TypeError, "Cm in torch.float32"),
    ("bf16_cpu", ValueError, "CUDA tensors"),
    ("bf16_wide_P", ValueError, "1..64 channels per head"),
    ("bf16_N_24", ValueError, "multiple of 16 up to 64"),
    ("bf16_N_80", ValueError, "multiple of 16 up to 64"),
])
def test_ssd_backward_wrapper_checks_before_build(monkeypatch, case, exc,
                                                  match):
    """Both routes check before anything is built; the bf16 route (chunked,
    tensor cores) takes the forward's geometry: P up to 64, N a multiple
    of 16 up to 64."""
    _no_build(monkeypatch, ssd_kernel)
    P, N = {"bf16_wide_P": (65, 16), "bf16_N_24": (8, 24),
            "bf16_N_80": (8, 80)}.get(case, (8, 16))
    a = _ssd_arrays(12, 1, 32, 2, P, N)
    t = {n: torch.tensor(v) for n, v in a.items()}
    if case.startswith("bf16"):
        for n in ("x", "Bm", "Cm", "dy"):
            t[n] = t[n].to(torch.bfloat16)
    dF = None
    if case == "x_half":
        t["x"], t["dy"] = t["x"].half(), t["dy"].half()
    elif case == "dt_bf16":
        t["dt"] = t["dt"].to(torch.bfloat16)
    elif case == "groups":
        t["Bm"] = torch.zeros(1, 32, 2, 16)
    elif case == "dy_dtype":
        t["dy"] = t["dy"].double()
    elif case == "dy_shape":
        t["dy"] = t["dy"][:, :16]
    elif case == "dF_shape":
        dF = t["dF"][..., :8]
    elif case == "dF_dtype":
        dF = t["dF"].double()
    elif case == "Cm_mixed":
        t["Cm"] = t["Cm"].to(torch.bfloat16)
    with pytest.raises(exc, match=match):
        ssd_kernel.ssd_scan_backward_cuda(*(t[n] for n in SSD_IN), t["dy"],
                                          dF)


@pytest.mark.parametrize("case,exc,match", [
    ("r_half", TypeError, "float32 or bfloat16"),
    ("w_bf16", TypeError, "w in torch.float32"),
    ("dy_dtype", ValueError, "dy like v"),
    ("dy_shape", ValueError, "dy like v"),
    ("dF_shape", ValueError, "d_final_state"),
    ("cpu", ValueError, "CUDA tensors"),
    ("k_mixed", TypeError, "k in torch.float32"),
])
def test_wkv6_backward_wrapper_checks_before_build(monkeypatch, case, exc,
                                                   match):
    _no_build(monkeypatch, wkv_kernel)
    a = _wkv_arrays(12, 1, 32, 2, 16, 0.4)
    t = {n: torch.tensor(v) for n, v in a.items()}
    dF = None
    if case == "r_half":
        for n in ("r", "k", "v", "dy"):
            t[n] = t[n].half()
    elif case == "w_bf16":
        t["w"] = t["w"].to(torch.bfloat16)
    elif case == "dy_dtype":
        t["dy"] = t["dy"].double()
    elif case == "dy_shape":
        t["dy"] = t["dy"][:, :16]
    elif case == "dF_shape":
        dF = t["dF"][..., :8]
    elif case == "k_mixed":
        t["k"] = t["k"].to(torch.bfloat16)
    with pytest.raises(exc, match=match):
        wkv_kernel.wkv6_scan_backward_cuda(*(t[n] for n in WKV_IN), t["dy"],
                                           dF)


def test_backward_sources_declare_the_wrappers_geometry():
    """The backward constants the wrappers check at load time are the
    sources' own (the check at load needs a card; this reads the text),
    the shared memory the wrappers reckon fits a block, and every kernel
    a route names is in its source. Both bf16 routes: 2 blocks an SM (SSD
    4 warps, WKV 8)."""
    import re
    for mod, fns in ((ssd_kernel, r"ssd_scan_\w+_kernel"),
                     (wkv_kernel, r"wkv6_scan_\w+_kernel")):
        text = mod.SOURCE.read_text()
        for name, value in (("kBwdThreads", mod.BWD_THREADS),
                            ("kBwdChunk", mod.BWD_CHUNK),
                            ("kBwdTcThreads", mod.BWD_TC_THREADS)):
            assert re.search(rf"constexpr int {name} = {value};", text), name
        assert f"// {mod.BWD_SMEM_BYTES:,}" in text
        assert f"// {mod.BWD_TC_SMEM_BYTES:,}" in text
        for smem in (mod.BWD_SMEM_BYTES, mod.BWD_TC_SMEM_BYTES):
            assert smem <= mod.MAX_SMEM_BYTES
        assert mod.blocks_per_sm(mod.BWD_TC_SMEM_BYTES) == 2
        assert set(mod.BACKWARD_ROUTES) == {torch.float32, torch.bfloat16}
        for route in mod.BACKWARD_ROUTES.values():
            for fn in re.findall(fns, route):
                assert f"{fn}(" in text, fn
    assert wkv_kernel.BWD_TC_THREADS == 256 and ssd_kernel.BWD_TC_THREADS == 128


# ------------------------------------------------ the card's tolerance

def _worst(got, want):
    return max(_rel(g.float(), w.float()) for g, w in zip(got, want))


@pytest.mark.parametrize("scan,fault", [
    ("ssd", "decay dropped"), ("ssd", "dy one token late"),
    ("wkv", "decay dropped"), ("wkv", "one token's decay dropped"),
    ("wkv", "dy one token late")])
def test_card_tolerance_catches_planted_faults(scan, fault):
    """The plain backward of a wrong kernel misses the card's tolerance
    in both dtypes, at the training path's mild decay: one that drops the
    decay (every token's: A = 0 or w = 1; or one token's, w_t = 1, which
    leaves that token's input k v as it was) or reads dy one token late."""
    if scan == "ssd":
        a, ref = _ssd_arrays(13, 2, 128, 3, 16, 16), _ssd_ref
        decay, dropped = "A", np.zeros_like
    else:
        a, ref = _wkv_arrays(13, 2, 128, 3, 16, 0.4), _wkv_ref
        decay, dropped = "w", np.ones_like
    want = ref(a, False, False, 32)[:-1]
    bad = dict(a)
    if fault == "decay dropped":
        bad[decay] = dropped(a[decay])
    elif fault == "one token's decay dropped":
        bad["w"] = a["w"].copy()
        bad["w"][:, 64] = 1.0
    else:
        bad["dy"] = np.roll(a["dy"], 1, axis=1)
        bad["dy"][:, 0] = 0
    worst = _worst(ref(bad, False, False, 32)[:-1], want)
    assert worst > max(CARD_TOL.values()), worst


# ------------------------------------------------ chip_smoke.py, rehearsed

def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_scan_backward_rehearsal_on_cpu():
    """chip_smoke.py's scan-backward phase at a tiny size through the
    plain backwards: the same checks the card run makes (the planted
    faults at the path case included); its tolerance is this file's."""
    smoke = _chip_smoke()
    assert smoke.SCAN_BWD_TOL == CARD_TOL
    ssd = [("train", 1, 64, 2, 16, 16, "bfloat16", 64, SSD_MILD)] + [
        c for c in smoke.SSD_BWD_CASES[2:] if c[1] * c[2] <= 128]
    wkv = [("train", 1, 64, 2, 16, "bfloat16", 0.4, 32)] + [
        c for c in smoke.WKV_BWD_CASES[2:] if c[1] * c[2] <= 128]
    recs = smoke.scan_backward_phase("cpu", ssd, wkv, time_it=False)
    assert set(recs) == {"ssd_scan_backward", "wkv6_scan_backward"}
    for rec in recs.values():
        assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"


def test_chip_smoke_scan_backward_bound():
    """The backwards' bound: each input and dy read once, each gradient
    written once; three times the chunked forward's products. At the
    training shapes 0.0390 ms (SSD, 131 MB) and 0.1102 ms (WKV, 369 MB)
    at 3.35 TB/s, both bound by bytes."""
    smoke = _chip_smoke()
    B, S, H, P, N = 4, 1024, 80, 64, 64
    x = torch.zeros(B, S, H, P, dtype=torch.bfloat16)
    dt = torch.zeros(B, S, H)
    A = D = torch.zeros(H)
    Bm = torch.zeros(B, S, 1, N, dtype=torch.bfloat16)
    grads = (x, dt, A, Bm, Bm, D)
    b = smoke.scan_backward_bound((x, dt, A, Bm, Bm, D, x), grads,
                                  smoke.ssd_bound(x, dt, Bm, D, 64)["flops"])
    assert b["bytes"] == 6 * x.numel() // 2 * 2 + 2 * dt.numel() * 4 \
        + 4 * Bm.numel() * 2 + 4 * H * 4
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.0390) < 1e-4
    r = torch.zeros(4, 1024, 64, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 1024, 64, 64)
    u = torch.zeros(64, 64)
    b = smoke.scan_backward_bound((r, r, r, w, u, r), (r, r, r, w, u),
                                  smoke.wkv_bound(r, w, u, 32)["flops"])
    assert b["bytes"] == 7 * r.numel() * 2 + 2 * w.numel() * 4 + 2 * u.numel() * 4
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.1102) < 1e-4
