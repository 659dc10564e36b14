"""The hand-written CUDA ``ssd_scan`` and ``wkv6_scan`` kernels against
their plain PyTorch versions on the card, output and final state, at the
unit-test shapes of tests/test_kernels.py in f32 and bf16, at mild and
aggressive decay for the WKV, and at the zamba2-2.7b / rwkv6-7b prefill
shapes; at strong decay (SSD, dt |A| up to 10) and extreme decay (WKV, w
down to 1e-30) in both dtypes; that bf16 launches the tensor-core route
and f32 the per-token one; their refusals on the card; and the two
recurrent smoke models' forward on the card against the same model on the
CPU. Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scan_gpu.py
"""
import math

import pytest
import torch

from repro_torch.arch import model as TM
from repro_torch.arch.params import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import ssd_chunked, ssd_sequential
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked, wkv6_sequential

# on |got - ref| / (1 + |ref|): tests/test_kernels.py's f32 tolerances
# (per-token sums against chunked ones); bf16 outputs round to ~3
# significant digits. Final states are f32 on both sides.
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
WKV_TOL = {"float32": 2e-4, "bfloat16": 2e-2}

# (B, S, H, P, N, chunk)
SSD_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 64, 2, 8, 32, 16),
              (1, 96, 1, 32, 16, 32), (2, 100, 2, 64, 64, 50),
              (4, 1024, 80, 64, 64, 64)]          # zamba2-2.7b prefill
# (B, S, H, K, chunk)
WKV_SHAPES = [(2, 128, 3, 16, 32), (1, 64, 2, 32, 16), (2, 100, 2, 64, 50),
              (4, 1024, 64, 64, 32)]              # rwkv6-7b prefill


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


def _ssd_inputs(dev, dtype, B, S, H, P, N, seed=3, dt_range=(1e-3, 0.1)):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dt_)
    lo, hi = dt_range
    dt = torch.rand(B, S, H, generator=g, device=dev) * (hi - lo) + lo
    A = -(torch.rand(H, generator=g, device=dev) * 1.5 + 0.5)
    Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=dev).to(dt_)
              for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    return x, dt, A, Bm, Cm, D


def _wkv_inputs(dev, dtype, B, S, H, K, wmin, seed=4):
    """w ~ U(wmin, 0.999); below 1e-6, log-uniform on [wmin, 0.999]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    r, k, v = (torch.randn(B, S, H, K, generator=g, device=dev).to(dt_)
               for _ in range(3))
    w = torch.rand(B, S, H, K, generator=g, device=dev)
    if wmin >= 1e-6:
        w = w * (0.999 - wmin) + wmin
    else:
        w = torch.exp(w * (math.log(0.999) - math.log(wmin)) + math.log(wmin))
    u = torch.randn(H, K, generator=g, device=dev)
    return r, k, v, w, u


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    B, S, H, P, N, chunk = shape
    args = _ssd_inputs(cuda_device, dtype, B, S, H, P, N)
    before = ssd_ops.invocation_count()
    y, st = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.invocation_count() == before + 1
    want_y, want_st = ssd_chunked(*args, chunk=chunk)
    assert y.dtype == args[0].dtype and y.shape == want_y.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all())
    assert _rel(y, want_y) <= SSD_TOL[dtype]
    assert _rel(st, want_st) <= SSD_TOL["float32"]


@pytest.mark.gpu
@pytest.mark.parametrize("wmin", [0.4, 0.001])        # mild + aggressive decay
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_kernel_matches_plain_on_card(cuda_device, dtype, wmin, shape):
    B, S, H, K, chunk = shape
    args = _wkv_inputs(cuda_device, dtype, B, S, H, K, wmin)
    before = wkv_ops.invocation_count()
    y, st = wkv_ops.wkv6_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.invocation_count() == before + 1
    want_y, want_st = wkv6_chunked(*args, chunk=chunk)
    assert y.dtype == args[0].dtype and y.shape == want_y.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, K, K)
    assert bool(torch.isfinite(y.float()).all())
    assert _rel(y, want_y) <= WKV_TOL[dtype]
    assert _rel(st, want_st) <= WKV_TOL["float32"]


# (B, S, H, P, N, chunk) at strong decay: dt ~ U(1, 5), A in -[0.5, 2].
# Held against the per-token recurrence: at this decay the chunked plain
# form's f32 differences of large cumulative decays miss a float64
# recurrence by about 1e-4, more than the f32 tolerance
SSD_STRONG_SHAPES = [(2, 128, 3, 16, 16, 32), (1, 256, 4, 64, 64, 64),
                     (2, 100, 2, 64, 64, 50)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_STRONG_SHAPES)
def test_ssd_kernel_matches_plain_at_strong_decay(cuda_device, dtype, shape):
    B, S, H, P, N, chunk = shape
    args = _ssd_inputs(cuda_device, dtype, B, S, H, P, N, seed=5,
                       dt_range=(1.0, 5.0))
    y, st = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_st = ssd_sequential(*args)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= SSD_TOL[dtype]
    assert _rel(st, want_st) <= SSD_TOL["float32"]


# (B, S, H, K, chunk) at extreme decay: w log-uniform down to 1e-30, held
# against the per-token recurrence (the chunked plain form misses a float64
# recurrence by about 2e-3 there)
WKV_EXTREME_SHAPES = [(2, 128, 3, 16, 32), (1, 256, 4, 64, 32),
                      (2, 100, 2, 64, 50)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WKV_EXTREME_SHAPES)
def test_wkv6_kernel_matches_plain_at_extreme_decay(cuda_device, dtype,
                                                     shape):
    B, S, H, K, chunk = shape
    args = _wkv_inputs(cuda_device, dtype, B, S, H, K, 1e-30, seed=6)
    y, st = wkv_ops.wkv6_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_st = wkv6_sequential(*args)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= WKV_TOL[dtype]
    assert _rel(st, want_st) <= WKV_TOL["float32"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_at_constant_decay_1e30(cuda_device, dtype):
    """Every token's decay 1e-30: the state keeps only the last token."""
    r, k, v, w, u = _wkv_inputs(cuda_device, dtype, 1, 96, 2, 64, 0.4,
                                seed=7)
    w = torch.full_like(w, 1e-30)
    y, st = wkv_ops.wkv6_scan(r, k, v, w, u, chunk=32)
    torch.cuda.synchronize()
    want_y, want_st = wkv6_sequential(r, k, v, w, u)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= WKV_TOL[dtype]
    assert _rel(st, want_st) <= WKV_TOL["float32"]


def _kernel_names(fn) -> set:
    """The CUDA kernels ``fn`` launches, by name, from torch.profiler. The
    window opens on one marker kernel (an in-place add): after an earlier
    profiler run in the process the window's first kernel can go
    unrecorded, so ``fn``'s launches come after it."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,want,other", [
    ("bfloat16", "_tc_kernel", None),
    ("float32", "scan_kernel", "_tc_kernel")])
def test_scan_routes_by_dtype(cuda_device, dtype, want, other):
    """bf16 launches each scan's tensor-core kernel, f32 its per-token
    kernel, at the path shapes' widths and at a narrow P / V."""
    for P in (64, 8):
        ssd_args = _ssd_inputs(cuda_device, dtype, 1, 96, 2, P, 64)
        wkv_args = _wkv_inputs(cuda_device, dtype, 1, 96, 2, 64, 0.4)
        if P != 64:
            wkv_args = (*wkv_args[:2], wkv_args[2][..., :P].contiguous(),
                        *wkv_args[3:])
        for op, args, name in ((ssd_ops.ssd_scan, ssd_args, "ssd_scan"),
                               (wkv_ops.wkv6_scan, wkv_args, "wkv6_scan")):
            names = _kernel_names(lambda: op(*args, chunk=32))
            hits = [n for n in names if name in n]
            assert any(want in n for n in hits), (dtype, P, names)
            if other is not None:
                assert not any(other in n for n in hits), (dtype, P, names)


@pytest.mark.gpu
def test_scan_kernels_refuse_on_card(cuda_device):
    """An init state, a second group or a bf16 decay never reach a
    launch; nothing is counted."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda_device, "bfloat16", 1, 64, 2, 8, 16)
    before = ssd_ops.invocation_count()
    with pytest.raises(ValueError, match="zero state"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D,
                         torch.ones(1, 2, 8, 16, device=cuda_device))
    with pytest.raises(ValueError, match="one group"):
        ssd_ops.ssd_scan(x, dt, A, Bm.expand(1, 64, 2, 16),
                         Cm.expand(1, 64, 2, 16), D)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_ops.ssd_scan(x[:, :48], dt[:, :48], A, Bm[:, :48], Cm[:, :48], D,
                         chunk=32)
    assert ssd_ops.invocation_count() == before
    r, k, v, w, u = _wkv_inputs(cuda_device, "bfloat16", 1, 64, 2, 16, 0.4)
    before = wkv_ops.invocation_count()
    with pytest.raises(ValueError, match="zero state"):
        wkv_ops.wkv6_scan(r, k, v, w, u,
                          torch.zeros(1, 2, 16, 16, device=cuda_device))
    with pytest.raises(TypeError, match="w in torch.float32"):
        wkv_ops.wkv6_scan(r, k, v, w.to(torch.bfloat16), u)
    assert wkv_ops.invocation_count() == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_recurrent_smoke_forward_on_card_matches_cpu(cuda_device, arch):
    """The smoke model in f32 through the kernels on the card against the
    same parameters through the plain versions on the CPU: logits and
    every prefill cache leaf."""
    cfg = get_config(arch + "-smoke").replace(dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    gpu = tree_map(lambda t: t.to(cuda_device), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    want, wstate = TM.forward(cfg, params, {"tokens": tokens}, mode="prefill")
    got, state = TM.forward(cfg, gpu, {"tokens": tokens.to(cuda_device)},
                            mode="prefill")
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-4
    for a, b in zip(tree_leaves(state["caches"]),
                    tree_leaves(wstate["caches"])):
        assert _rel(a.cpu(), b) < 1e-4
