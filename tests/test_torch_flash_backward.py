"""The gradient of the port's ``flash_attention`` on the CPU: the plain
backward (``attention_backward_reference``, the yardstick of the CUDA
backward kernels) against ``torch.autograd`` through
``attention_reference`` and against ``jax.vjp`` of the reference's
``attention_xla`` (what ``jax.grad`` differentiates on the training path:
no Pallas kernel of the reference defines a VJP), and the
``torch.autograd.Function`` that carries it. Causal and full attention,
Sq < Skv, groups 1 and 2, head dims 16 to 128, ragged lengths, f32.
Inputs and the output's gradient are drawn with numpy and handed to both
packages. Also the guard that keeps the two forward-only kernels
(``decode_attention`` and ``fleet_mlp``) from returning gradient-less
results on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.xla import attention_xla
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_reference)
from repro_torch.kernels.fleet_mlp import ops as fleet_ops

torch.set_num_threads(1)

# f32 on |got - ref| / (1 + |ref|): tests/test_kernels.py's attention
# tolerance. The two sides sum the same f32 products in other orders
# (einsum against XLA's dots); nothing is rounded to a narrower type.
TOL = 2e-5

# (B, Sq, Skv, H, KV, D, causal)
CASES = [
    (2, 16, 16, 4, 2, 16, True),        # G = 2
    (1, 24, 24, 2, 2, 80, True),        # G = 1, D 80
    (1, 8, 40, 4, 2, 128, True),        # Sq < Skv, bottom-right mask
    (2, 13, 29, 4, 4, 32, False),       # ragged, full attention
    (1, 37, 37, 4, 2, 80, False),       # ragged, full, G = 2
    (1, 19, 50, 2, 1, 128, True),       # ragged Sq < Skv, G = 2
]
IDS = [f"B{c[0]}-Sq{c[1]}-Skv{c[2]}-H{c[3]}-KV{c[4]}-D{c[5]}-"
       f"{'causal' if c[6] else 'full'}" for c in CASES]


def _inputs(case, seed):
    B, Sq, Skv, H, KV, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want) / (1 + np.abs(want))))
    assert err <= tol, err


def _plain_grads(q, k, v, do, causal):
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = attention_reference(tq, tk, tv, causal=causal, return_lse=True)
    return attention_backward_reference(tq, tk, tv, o, lse, tdo, causal)


def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda q, k, v: attention_xla(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    """Step by step against autograd through the plain forward."""
    q, k, v, do = _inputs(case, 1)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention_reference(tq, tk, tv, causal=case[6])
    out.backward(torch.tensor(do))
    for got, want in zip(_plain_grads(q, k, v, do, case[6]),
                         (tq.grad, tk.grad, tv.grad)):
        _close(got, want.numpy())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad(case):
    q, k, v, do = _inputs(case, 2)
    for got, want in zip(_plain_grads(q, k, v, do, case[6]),
                         _jax_grads(q, k, v, do, case[6])):
        _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_gradient_matches_jax_grad(case):
    """``flash_attention`` under autograd on CPU tensors: the Function's
    plain backward, one backward count per call, the output unchanged."""
    q, k, v, do = _inputs(case, 3)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    fa_ops.reset_invocation_count()
    out = fa_ops.flash_attention(tq, tk, tv, causal=case[6])
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = fa_ops.flash_attention(tq, tk, tv, causal=case[6])
    assert plain.grad_fn is None and torch.equal(out.detach(), plain)
    out.backward(torch.tensor(do))
    assert fa_ops.invocation_count() == 2
    assert fa_ops.backward_invocation_count() == 1
    for got, want in zip((tq.grad, tk.grad, tv.grad),
                         _jax_grads(q, k, v, do, case[6])):
        _close(got, want)


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_bf16_gradient_as_inputs(case):
    """bf16 inputs: gradients come back in bf16, within bf16 rounding of
    the f32 gradients of the same (rounded) inputs."""
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16)
                   for a in _inputs(case, 4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.flash_attention(*leaves, causal=case[6]).backward(do)
    want = _plain_grads(*(t.float().numpy() for t in (q, k, v, do)), case[6])
    for got, ref in zip((t.grad for t in leaves), want):
        assert got.dtype == torch.bfloat16
        _close(got.float(), ref.numpy(), tol=2e-2)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_is_the_rows_logsumexp(case):
    q, k, v, _ = (torch.tensor(a) for a in _inputs(case, 5))
    B, Sq, Skv, H, KV, D, causal = case
    _, lse = attention_reference(q, k, v, causal=causal, return_lse=True)
    kk = k.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * D ** -0.5
    if causal:
        mask = torch.arange(Skv)[None] <= torch.arange(Sq)[:, None] + Skv - Sq
        s = s.masked_fill(~mask, -torch.inf)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(lse, torch.logsumexp(s, dim=-1).numpy())


def test_backward_wrapper_checks_before_any_build():
    """What the backward kernels cannot take raises before a build: their
    shared memory fits a block at every head dim the forward takes, and
    wrong dtypes or shapes raise in the wrapper."""
    for d in range(8, 129, 8):
        for dt in (torch.float32, torch.bfloat16):
            assert fa_kernel.backward_smem_bytes(d, dt) \
                <= fa_kernel.MAX_SMEM_BYTES
            fa_kernel.check_launch(d, dt)
    assert fa_kernel.backward_smem_bytes(128, torch.float32) == 166400
    assert fa_kernel.backward_smem_bytes(128) == 197672
    q = torch.zeros(1, 8, 2, 16)
    kv = torch.zeros(1, 8, 1, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_backward_cuda(
            *(t.half() for t in (q, kv, kv, q, q)), lse, True)
    with pytest.raises(ValueError, match="f32 lse"):
        fa_kernel.flash_attention_backward_cuda(q, kv, kv, q, q,
                                                lse.double(), True)
    with pytest.raises(ValueError, match="do not match"):
        fa_kernel.flash_attention_backward_cuda(q, kv, kv, q, q, lse[:, :1],
                                                True)


def test_guard_raises_only_where_autograd_records():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match="k: .*no training path of the JAX package"):
        common.forbid_autograd("k", x, None)
    with torch.no_grad():
        common.forbid_autograd("k", x)
    common.forbid_autograd("k", x.detach())


def test_guarded_kernels_still_differentiate_on_cpu():
    """The two forward-only kernels' plain versions carry gradients on
    CPU tensors, as before the guard."""
    g = torch.Generator().manual_seed(6)

    def leaf(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(True)

    q, kc, vc = leaf(2, 4, 16), leaf(2, 8, 2, 16), leaf(2, 8, 2, 16)
    out = dec_ops.decode_attention(q, kc, vc, torch.tensor([3, 8]))
    x, w, b = leaf(3, 2, 5), leaf(3, 5, 4), leaf(3, 4)
    y = fleet_ops.fleet_mlp(x, [w], [b])
    (out.sum() + y.sum()).backward()
    for t in (q, kc, vc, x, w, b):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def _bf16_kernel_model(q, k, v, o, lse, do, causal):
    """The bf16 backward kernels' arithmetic in plain PyTorch (Sq = Skv):
    f32 products of the bf16 inputs; P in f32, rounded once to bf16 as the
    operand of dV = P^T dO; dS = P o (dP - delta) formed from the
    UNROUNDED f32 P and rounded once to bf16, the one operand of both
    dQ = dS K (the dQ kernel) and dK = dS^T Q (the dK/dV kernel); the
    results rounded to bf16."""
    from repro_torch.kernels.flash_attention.ref import (_group, _ungroup,
                                                         _visible)
    B, S, H, D = q.shape
    KV = k.shape[2]
    bf, f32, scale = torch.bfloat16, torch.float32, D ** -0.5
    qg, og, dog = (_group(t.to(f32), KV) for t in (q, o, do))
    kg, vg = (t.to(f32).permute(0, 2, 1, 3) for t in (k, v))
    s = torch.einsum("bkgqd,bkud->bkgqu", qg, kg) * scale
    p = torch.exp(s - lse.reshape(B, KV, H // KV, S, 1))
    if causal:
        p = torch.where(_visible(S, S, 0, q.device), p, 0.0)
    delta = torch.sum(dog * og, dim=-1, keepdim=True)
    dp = torch.einsum("bkgqd,bkud->bkgqu", dog, vg)
    ds = (p * (dp - delta)).to(bf).to(f32)
    dq = torch.einsum("bkgqu,bkud->bkgqd", ds, kg) * scale
    dk = torch.einsum("bkgqu,bkgqd->bkud", ds, qg) * scale
    dv = torch.einsum("bkgqu,bkgqd->bkud", p.to(bf).to(f32), dog)
    return (_ungroup(dq).to(bf), dk.permute(0, 2, 1, 3).to(bf),
            dv.permute(0, 2, 1, 3).to(bf))


# (H, KV): groups of 1, 2 and 4 query heads per KV head
FAULT_GROUPS = [(2, 2), (4, 2), (8, 2)]


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "full"])
@pytest.mark.parametrize("heads", FAULT_GROUPS,
                         ids=[f"G{h // kv}" for h, kv in FAULT_GROUPS])
def test_backward_check_catches_planted_faults(causal, heads):
    """chip_smoke.py holds the bf16 backward to |got - ref| / (1 + |ref|)
    <= 2e-2, where most gradient entries at S 1024 lie well below 1. At
    S 1024, D 128, causal and full, groups 1, 2 and 4, the kernels' own
    roundings (modelled) stay under it in dq, dk and dv, while dK/dV
    without the last 64-row q tile, or without the last head of each GQA
    group (the smoke's planted faults: that tile's or head's output
    gradient zeroed), miss it five times over."""
    from repro_torch.kernels.flash_attention.kernel import BLOCK_Q
    H, KV = heads
    G = H // KV
    rng = np.random.default_rng(18)
    q, k, v, do = (torch.tensor(rng.normal(size=(1, 1024, n, 128)),
                                dtype=torch.float32).to(torch.bfloat16)
                   for n in (H, KV, KV, H))
    o, lse = attention_reference(q, k, v, causal=causal, return_lse=True)
    want = attention_backward_reference(q, k, v, o, lse, do, causal)

    def rel(got, ref):
        ref = ref.float()
        return float(((got.float() - ref).abs() / (1 + ref.abs())).max())

    model = _bf16_kernel_model(q, k, v, o, lse, do, causal)
    assert max(rel(a, b) for a, b in zip(model, want)) <= 2e-2
    late, head = do.clone(), do.clone()
    late[:, -BLOCK_Q:] = 0
    head[:, :, G - 1::G] = 0
    for d in (late, head):
        bad = attention_backward_reference(q, k, v, o, lse, d, causal)
        assert min(rel(a, b) for a, b in zip(bad[1:], want[1:])) > 5 * 2e-2


@pytest.mark.parametrize("head_dim", range(8, 129, 8))
def test_bf16_backward_smem_fits_every_head_dim(head_dim):
    """The bf16 backward's larger block (dQ: 128 q rows of q and dO and a
    two-stage ring of 128-key K and V tiles, in one 64-column atom up to
    D 64 and two above) fits a block's shared memory at every head dim
    the forward's bf16 route takes."""
    need = fa_kernel.backward_smem_bytes(head_dim)
    assert need <= fa_kernel.MAX_SMEM_BYTES
    assert need == (99368 if head_dim <= 64 else 197672)
    fa_kernel.check_launch(head_dim, torch.bfloat16)
