"""The hand-written CUDA ``fleet_mlp`` kernel against its plain PyTorch
version on the card, at the unit-test shapes, a ragged N and the scoring
shape. Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet_mlp_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.fleet_mlp import ops
from repro_torch.kernels.fleet_mlp.ref import fleet_mlp_reference

# the tolerances of test_torch_fleet_mlp.py (TOL * 10 of tests/test_kernels.py)
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# (N, b, F, hidden, depth): unit-test shapes, a ragged N, the scoring shape
SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1),
          (5, 3, 12, 24, 4), (500, 1, 54, 512, 5), (512, 1, 54, 512, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    N, b, F, hidden, depth = shape
    g = torch.Generator(device=cuda_device).manual_seed(4)
    sizes = [F] + [hidden] * (depth - 1) + [1]

    def draw(*s, scale=1.0):
        t = torch.randn(*s, generator=g, device=cuda_device) * scale
        return t.to(getattr(torch, dtype))

    x = draw(N, b, F)
    ws = [draw(N, sizes[i], sizes[i + 1], scale=(2 / sizes[i]) ** 0.5)
          for i in range(depth)]
    bs = [draw(N, sizes[i + 1]) for i in range(depth)]
    before = ops.invocation_count()
    got = ops.fleet_mlp(x, ws, bs)
    torch.cuda.synchronize()
    assert ops.invocation_count() == before + 1
    want = fleet_mlp_reference(x, ws, bs)
    assert got.shape == (N, b, 1) and got.dtype == x.dtype
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_hold(cuda_device):
    x = torch.zeros(2, 64, 8, device=cuda_device)
    ws = [torch.zeros(2, 8, 1024, device=cuda_device),
          torch.zeros(2, 1024, 1, device=cuda_device)]
    bs = [torch.zeros(2, 1024, device=cuda_device),
          torch.zeros(2, 1, device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        ops.fleet_mlp(x, ws, bs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fleet_mlp(x.transpose(0, 1).contiguous().transpose(0, 1),
                      ws, bs)
    with pytest.raises(TypeError):
        ops.fleet_mlp(x.half(), [w.half() for w in ws], [b.half() for b in bs])
