"""The hand-written CUDA ``fleet_mlp`` kernel against its plain PyTorch
version on the card, at the unit-test shapes, a ragged N, the scoring
shape (the wide route), the widths deployments use (the narrow route) and
both routes' edges; the library's own launch plan against the wrapper's
``plan_launch``. Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet_mlp_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.fleet_mlp import kernel, ops
from repro_torch.kernels.fleet_mlp.ref import fleet_mlp_reference

# the tolerances of test_torch_fleet_mlp.py (TOL * 10 of tests/test_kernels.py)
TOL = {"float32": 2e-4, "bfloat16": 2e-1}
# (N, b, F, hidden, depth): unit-test shapes, a ragged N, the scoring
# shape; the widths deployments use (hidden 64 and 32, Table 3's 16 over
# 30 features); the routes' edges: an N that fills no whole narrow block,
# layers off 16-byte alignment on each route (F 7 x width 13, 7 x 131), b 3
# on each route, narrow widths at a b whose buffers send them wide, and
# width 512 at a b that leaves the wide ring three stages, then two small
SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1),
          (5, 3, 12, 24, 4), (500, 1, 54, 512, 5), (512, 1, 54, 512, 5),
          (512, 1, 54, 64, 5), (512, 1, 54, 32, 5), (1024, 1, 30, 16, 5),
          (13, 1, 54, 32, 5), (6, 2, 7, 13, 3), (5, 2, 7, 131, 3),
          (9, 3, 54, 64, 5), (5, 3, 54, 512, 5), (7, 100, 54, 64, 2),
          (4, 40, 54, 512, 3), (3, 50, 54, 512, 5)]


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


@pytest.mark.gpu
def test_library_plan_agrees_with_plan_launch(cuda_device):
    """The route, threads, shared memory, grid and ring the built library
    plans for a launch are ``plan_launch``'s, on this card's SM count; a
    shape ``plan_launch`` refuses the library refuses too."""
    lib = kernel._library()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    shapes = [(rows, [F] + [hidden] * (depth - 1) + [1], N)
              for N, rows, F, hidden, depth in SHAPES]
    shapes += [(rows, list(widths), n) for rows, widths, n in
               kernel._PLAN_PROBES]
    shapes += [(1, [F, h, h, 1], 7) for F in (1, 7, 54, 300)
               for h in (1, 2, 31, 32, 33, 63, 64, 65, 128, 4096)]
    for rows, widths, n in shapes:
        got = kernel.library_plan(lib, rows, widths, n, sms)
        try:
            p = kernel.plan_launch(rows, widths)
        except ValueError:
            assert got[0] == -1, (rows, widths, got)
            continue
        assert got == (kernel.ROUTES.index(p.route), p.threads, p.smem,
                       p.blocks(n, sms), p.stages, p.stage_bytes), \
            (rows, widths, n, got, p)
