"""The hand-written CUDA ``ssd_scan`` and ``wkv6_scan`` kernels against
their plain PyTorch versions on the card, output and final state, at the
unit-test shapes of tests/test_kernels.py in f32 and bf16, at mild and
aggressive decay for the WKV, and at the zamba2-2.7b / rwkv6-7b prefill
shapes; their refusals on the card; and the two recurrent smoke models'
forward on the card against the same model on the CPU. Imports no JAX,
so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scan_gpu.py
"""
import pytest
import torch

from repro_torch.arch import model as TM
from repro_torch.arch.params import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import ssd_chunked
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked

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


def _ssd_inputs(dev, dtype, B, S, H, P, N, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dt_)
    dt = torch.rand(B, S, H, generator=g, device=dev) * 0.099 + 1e-3
    A = -(torch.rand(H, generator=g, device=dev) * 1.5 + 0.5)
    Bm, Cm = (torch.randn(B, S, 1, N, generator=g, device=dev).to(dt_)
              for _ in range(2))
    D = torch.randn(H, generator=g, device=dev)
    return x, dt, A, Bm, Cm, D


def _wkv_inputs(dev, dtype, B, S, H, K, wmin, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    r, k, v = (torch.randn(B, S, H, K, generator=g, device=dev).to(dt_)
               for _ in range(3))
    w = torch.rand(B, S, H, K, generator=g, device=dev) * (0.999 - wmin) + wmin
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
