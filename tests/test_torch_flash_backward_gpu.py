"""The hand-written CUDA ``flash_attention`` backward on the card, against
the plain backward (``attention_backward_reference``) on the same inputs
and the forward's own ``lse``: both dtypes, causal and full, Sq < Skv,
groups 1 and 2, head dims 16 to 128, ragged lengths and the training
shape (qwen3-1.7b, B 4, S 1024, H 16, KV 8, D 128). Also the ``lse`` both
forward routes write, the backward's determinism (two runs bitwise
equal), the Function's counts and the four forward-only kernels' refusal
under autograd. Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_backward_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_reference)
from repro_torch.kernels.fleet_mlp import ops as fleet_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

# |got - ref| / (1 + |ref|): f32 at tests/test_kernels.py's attention
# tolerance (sums in another order, CUDA-core FMAs); bf16 at the attention
# kernels' 2e-2: the tensor-core route rounds P and dS to bf16 as product
# operands (2^-9 relative each) and the gradients once more on the way out
# (the plain backward keeps P and dS in f32); 1e-2 was read at the
# training shape
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# lse: f32 in both routes; the bf16 route's exp2 runs on the special
# function unit (ex2.approx, about 2 ulp), the f32 route's expf
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}

# (B, Sq, Skv, H, KV, D)
SHAPES = [
    (1, 128, 128, 4, 4, 32), (2, 64, 64, 4, 2, 16), (1, 96, 96, 4, 2, 80),
    (1, 64, 256, 4, 2, 32), (2, 37, 200, 4, 1, 80), (1, 100, 100, 16, 8, 128),
    (4, 1024, 1024, 16, 8, 128),       # qwen3-1.7b training
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, shape, dtype, seed):
    B, Sq, Skv, H, KV, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(s, generator=g, device=device).to(dt)
                 for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                           (B, Sq, H, D)))


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(((got.float() - want.float()).abs()
                 / (1 + want.float().abs())).max())
    assert err <= tol, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, causal,
                                               shape):
    q, k, v, do = _inputs(cuda_device, shape, dtype, 11)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, causal, with_lse=True)
    got = fa_kernel.flash_attention_backward_cuda(q, k, v, out, do, lse,
                                                  causal)
    want = attention_backward_reference(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_lse_on_card(cuda_device, dtype, causal, shape):
    """Both routes write the plain version's lse, and the output with lse
    is bitwise the output without it."""
    q, k, v, _ = _inputs(cuda_device, shape, dtype, 12)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, causal, with_lse=True)
    plain = fa_kernel.flash_attention_cuda(q, k, v, causal)
    _, want = attention_reference(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    _close(lse, want, LSE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_is_deterministic(cuda_device, dtype):
    q, k, v, do = _inputs(cuda_device, (2, 300, 300, 8, 2, 128), dtype, 13)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, True, with_lse=True)
    a = fa_kernel.flash_attention_backward_cuda(q, k, v, out, do, lse, True)
    b = fa_kernel.flash_attention_backward_cuda(q, k, v, out, do, lse, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_gradient_through_kernels(cuda_device, dtype):
    """``flash_attention`` under autograd on the card: one forward and one
    backward count, gradients equal to the plain backward's."""
    q, k, v, do = _inputs(cuda_device, (2, 200, 200, 8, 4, 64), dtype, 14)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.reset_invocation_count()
    out = fa_ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert fa_ops.invocation_count() == 1
    assert fa_ops.backward_invocation_count() == 1
    o, lse = attention_reference(q, k, v, causal=True, return_lse=True)
    want = attention_backward_reference(q, k, v, out.detach(), lse, do, True)
    for t, w in zip(leaves, want):
        _close(t.grad, w, TOL[dtype])


@pytest.mark.gpu
def test_forward_only_kernels_refuse_autograd(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(15)

    def leaf(*shape):
        return torch.randn(*shape, generator=g,
                           device=cuda_device).requires_grad_(True)

    calls = {
        "decode_attention": lambda: dec_ops.decode_attention(
            leaf(2, 4, 64), leaf(2, 128, 2, 64), leaf(2, 128, 2, 64),
            torch.tensor([5, 128], dtype=torch.int32, device=cuda_device)),
        "fleet_mlp": lambda: fleet_ops.fleet_mlp(
            leaf(4, 2, 8), [leaf(4, 8, 16), leaf(4, 16, 1)],
            [leaf(4, 16), leaf(4, 1)]),
        "ssd_scan": lambda: ssd_ops.ssd_scan(
            leaf(1, 64, 2, 64), torch.rand(1, 64, 2, device=cuda_device),
            -torch.ones(2, device=cuda_device), leaf(1, 64, 1, 64),
            leaf(1, 64, 1, 64), torch.ones(2, device=cuda_device)),
        "wkv6_scan": lambda: wkv_ops.wkv6_scan(
            leaf(1, 64, 2, 64), leaf(1, 64, 2, 64), leaf(1, 64, 2, 64),
            torch.full((1, 64, 2, 64), 0.9, device=cuda_device),
            torch.zeros(2, 64, device=cuda_device)),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            call()
