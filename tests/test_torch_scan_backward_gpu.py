"""The hand-written CUDA backward kernels of ``ssd_scan`` and ``wkv6_scan``
against their plain backwards (float64) on the card: every gradient, in
f32 and bf16, at the unit-test shapes and the zamba2-2.7b / rwkv6-7b
training shapes, at mild and strong decay (SSD dt |A| up to 10, WKV w down
to 1e-30), with and without a final-state gradient; three calls bitwise
equal, also from a fresh thread as autograd's engine calls a backward; the
WKV bf16 route's three launches a call;
the ops under autograd on the card (their gradients the wrapper's, one
backward counted, an initial state refused); and one training step of the
two recurrent smoke models on the card against the same step on the CPU.
Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scan_backward_gpu.py
"""
import math
import threading

import pytest
import torch

from repro_torch.arch import model as TM
from repro_torch.arch.params import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_lm_batch
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import ssd_backward_reference
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_backward_reference
from repro_torch.train import init_state, make_train_step

# on |got - ref| / (1 + |ref|), as chip_smoke.SCAN_BWD_TOL (its comment
# gives the reasons): in f32 the kernels' f32 sums over up to S tokens and
# over the whole state against float64; bf16 gradients are rounded once
# from f32. Gradients the kernels return in f32 (ddt, dA, dD, dw, du) take
# the f32 tolerance in either dtype.
TOL = {"float32": 1e-3, "bfloat16": 2e-2}

# (B, S, H, P, N, chunk): the test shapes, a ragged S, the training shape,
# then P 20 (not a multiple of 8: the bf16 route's element-wise loads), N
# 48 and S 1000 (the bf16 route's last 64-token chunk ragged)
SSD_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 96, 1, 32, 16, 32),
              (2, 100, 2, 64, 64, 50), (4, 1024, 80, 64, 64, 64),
              (1, 128, 2, 20, 32, 32), (1, 128, 2, 64, 48, 64),
              (1, 1000, 2, 64, 64, 50)]
# (B, S, H, K, V, chunk): the test shapes, a ragged S, the training shape,
# then S 1000 (the bf16 route's last 32-token chunk ragged), K 48, and V 50
# beside K 64 (the bf16 route's element-wise loads)
WKV_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 64, 2, 32, 32, 16),
              (2, 100, 2, 64, 64, 50), (4, 1024, 64, 64, 64, 32),
              (1, 1000, 2, 64, 64, 50), (1, 128, 2, 48, 48, 32),
              (1, 128, 2, 64, 50, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


def _ssd_inputs(dev, dtype, B, S, H, P, N, strong, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    lo, hi = (1.0, 5.0) if strong else (1e-3, 0.1)
    x, dy = (torch.randn(B, S, H, P, generator=g, device=dev).to(dt_)
             for _ in range(2))
    dt = torch.rand(B, S, H, generator=g, device=dev) * (hi - lo) + lo
    A = -(torch.rand(H, generator=g, device=dev) * 1.5 + 0.5)
    Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=dev).to(dt_)
              for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    dF = torch.randn(B, H, P, N, generator=g, device=dev)
    return (x, dt, A, Bm, Cm, D, dy), dF


def _wkv_inputs(dev, dtype, B, S, H, K, V, wmin, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    r, k = (torch.randn(B, S, H, K, generator=g, device=dev).to(dt_)
            for _ in range(2))
    v, dy = (torch.randn(B, S, H, V, generator=g, device=dev).to(dt_)
             for _ in range(2))
    w = torch.rand(B, S, H, K, generator=g, device=dev)
    if wmin >= 1e-6:
        w = w * (0.999 - wmin) + wmin
    else:
        w = torch.exp(w * (math.log(0.999) - math.log(wmin)) + math.log(wmin))
    u = torch.randn(H, K, generator=g, device=dev)
    dF = torch.randn(B, H, K, V, generator=g, device=dev)
    return (r, k, v, w, u, dy), dF


def _check(got, want, dtype):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all()
        tol = TOL["float32"] if b.dtype == torch.float32 else TOL[dtype]
        assert _rel(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_backward_kernel_matches_plain(cuda_device, shape, dtype, strong,
                                           final):
    *dims, chunk = shape
    inputs, dF = _ssd_inputs(cuda_device, dtype, *dims, strong)
    dF = dF if final else None
    got = ssd_kernel.ssd_scan_backward_cuda(*inputs, dF)
    want = ssd_backward_reference(*inputs, None, dF, chunk=chunk)[:6]
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("wmin", [0.4, 1e-3, 1e-30])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_backward_kernel_matches_plain(cuda_device, shape, dtype, wmin,
                                            final):
    *dims, chunk = shape
    inputs, dF = _wkv_inputs(cuda_device, dtype, *dims, wmin)
    dF = dF if final else None
    got = wkv_kernel.wkv6_scan_backward_cuda(*inputs, dF)
    want = wkv6_backward_reference(*inputs, None, dF, chunk=chunk)[:5]
    torch.cuda.synchronize()
    _check(got, want, dtype)


def _three_calls(fn):
    """Two calls on this thread and one from a fresh thread (autograd's
    engine runs a backward on its own thread)."""
    out = [fn(), fn()]
    got = {}

    def run():
        try:
            got["grads"] = fn()
            torch.cuda.synchronize()
        except Exception as e:      # re-raised on the test's thread
            got["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in got:
        raise got["error"]
    torch.cuda.synchronize()
    return out + [got["grads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_backwards_are_deterministic_at_the_training_shapes(cuda_device,
                                                                 dtype):
    inputs, dF = _ssd_inputs(cuda_device, dtype, 4, 1024, 80, 64, 64, False)
    a, b, c = _three_calls(
        lambda: ssd_kernel.ssd_scan_backward_cuda(*inputs, dF))
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    inputs, dF = _wkv_inputs(cuda_device, dtype, 4, 1024, 64, 64, 64, 0.4)
    a, b, c = _three_calls(
        lambda: wkv_kernel.wkv6_scan_backward_cuda(*inputs, dF))
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))


@pytest.mark.gpu
def test_wkv6_backward_bf16_launches(cuda_device):
    """One bf16 backward call is three launches, the state sweep, the
    reverse sweep and the sum over batch rows, as ``torch.profiler`` counts
    them over three calls. The window opens on one marker kernel (an
    in-place add): after an earlier profiler run in the process the
    window's first kernel can go unrecorded, so the count starts past
    it."""
    from torch.profiler import ProfilerActivity, profile
    inputs, dF = _wkv_inputs(cuda_device, "bfloat16", 2, 128, 3, 64, 64, 0.4)
    wkv_kernel.wkv6_scan_backward_cuda(*inputs, dF)
    marker = torch.zeros(1, device=cuda_device)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            wkv_kernel.wkv6_scan_backward_cuda(*inputs, dF)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if "wkv6_scan" in n or "sum_mid" in n]
    others = [n for n in names if n not in kernels]
    assert len(others) <= 1 and all("add" in n for n in others), others
    assert len(kernels) == 3 * calls, kernels
    for fn in ("wkv6_scan_tc_kernel<true, true>", "wkv6_scan_bwd_tc_kernel",
               "sum_mid_kernel"):
        assert sum(fn in n for n in kernels) == calls, (fn, kernels)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_ops_differentiate_on_card(cuda_device, dtype):
    """The ops under autograd on CUDA tensors: the gradients are the
    backward wrappers' bitwise, one forward and one backward counted, and
    an initial state is refused before any launch."""
    inputs, dF = _ssd_inputs(cuda_device, dtype, 2, 128, 3, 64, 64, False)
    leaves = [t.clone().requires_grad_(True) for t in inputs[:6]]
    ssd_ops.reset_invocation_count()
    y, final = ssd_ops.ssd_scan(*leaves, chunk=64)
    grads = torch.autograd.grad((y, final), leaves, (inputs[6], dF))
    want = ssd_kernel.ssd_scan_backward_cuda(*inputs, dF)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert (ssd_ops.invocation_count(),
            ssd_ops.backward_invocation_count()) == (1, 1)
    with pytest.raises(ValueError, match="zero state"):
        ssd_ops.ssd_scan(*leaves, torch.zeros_like(dF))
    inputs, dF = _wkv_inputs(cuda_device, dtype, 2, 128, 3, 64, 64, 0.4)
    leaves = [t.clone().requires_grad_(True) for t in inputs[:5]]
    wkv_ops.reset_invocation_count()
    y, final = wkv_ops.wkv6_scan(*leaves, chunk=32)
    grads = torch.autograd.grad((y, final), leaves, (inputs[5], dF))
    want = wkv_kernel.wkv6_scan_backward_cuda(*inputs, dF)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert (wkv_ops.invocation_count(),
            wkv_ops.backward_invocation_count()) == (1, 1)
    with pytest.raises(ValueError, match="zero state"):
        wkv_ops.wkv6_scan(*leaves, torch.zeros_like(dF))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "rwkv6-7b-smoke"])
def test_recurrent_smoke_train_step_on_card_matches_cpu(cuda_device, arch):
    """One f32 train step of the smoke model on the card (the scans'
    forward and backward kernels) against the same step on the CPU (the
    plain versions): the loss and every gradient leaf (f32 matmuls stay
    f32: PyTorch's default, no TF32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).replace(dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    batch = synthetic_lm_batch(cfg.vocab_size, 2, 64, seed=3, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        seen = []
        step = make_train_step(cfg, grad_hook=lambda g: seen.append(g) or g)
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        _, _, m = step(p, init_state(p), b)
        out[dev] = (float(m["loss"]), tree_leaves(seen[0]))
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * (
            float(b.abs().max()) + 1e-12)
