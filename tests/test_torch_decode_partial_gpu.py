"""``decode_attention``'s stats route (the CUDA kernel's partial pass with a
combine that keeps o, m and l in f32) against its plain version on the
card: the unit-test and serving shapes, caches shorter than one 64-slot
tile, empty rows and shards past every length (m = -1e30, l = 0, o = 0,
never NaN), and shards recombined by the distributed flash-decode's
combine against the one-shot kernel. Imports no JAX, so it runs on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_partial_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.distributed import (
    _partial, combine_partials)
from repro_torch.kernels.decode_attention.ref import (
    NEG_INF, decode_attention_partial_reference)

# tests/test_kernels.py's tolerances, on |got - ref| / (1 + |ref|)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, S, H, KV, D): the unit shapes, S below one tile, GQA groups 6 and
# 8, the serving shapes of qwen3-1.7b and dbrx-132b
SHAPES = [(3, 256, 4, 2, 32), (2, 128, 8, 8, 64), (3, 200, 4, 4, 80),
          (2, 32, 8, 2, 128), (3, 48, 12, 2, 64), (2, 256, 16, 2, 128),
          (8, 2048, 16, 8, 128), (4, 512, 48, 8, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=7):
    B, S, H, KV, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, generator=g, device=device).to(dt)
    k, v = (torch.randn(B, S, KV, D, generator=g, device=device).to(dt)
            for _ in range(2))
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=device,
                            dtype=torch.int32)
    lengths[0] = 0
    return q, k, v, lengths


def _rel(got, want):
    return float(((got.float() - want.float()).abs()
                  / (1 + want.float().abs())).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_route_matches_plain_on_card(cuda_device, dtype, shape):
    q, k, v, lengths = _inputs(shape, dtype, cuda_device)
    before = dec_ops.partial_invocation_count()
    got = dec_ops.decode_attention_partial(q, k, v, lengths)
    torch.cuda.synchronize()
    assert dec_ops.partial_invocation_count() == before + 1
    want = decode_attention_partial_reference(q, k, v, lengths)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
    # o is an unnormalised sum: read in units of its row's denominator
    scale = torch.clamp_min(want[2], 1.0)[..., None]
    assert _rel(got[0] / scale, want[0] / scale) <= TOL[dtype]
    assert _rel(got[1], want[1]) <= TOL[dtype]
    assert _rel(got[2], want[2]) <= TOL[dtype]
    o, m, l = got
    assert bool((m[0] == NEG_INF).all()) and bool((l[0] == 0).all())
    assert bool((o[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shards_recombine_to_the_one_shot_kernel(cuda_device, dtype, n):
    q, k, v, lengths = _inputs((4, 512, 16, 2, 128), dtype, cuda_device)
    lengths[1] = 10                       # ends in the first shard
    S_loc = k.shape[1] // n
    parts = [_partial(q, k[:, i * S_loc:(i + 1) * S_loc],
                      v[:, i * S_loc:(i + 1) * S_loc], lengths, i * S_loc)
             for i in range(n)]
    out = combine_partials(*(torch.stack(t) for t in zip(*parts)))
    assert not bool(torch.isnan(out).any())
    one = dec_ops.decode_attention(q, k, v, lengths)
    assert _rel(out.to(q.dtype), one) <= TOL[dtype]
    assert bool((out[0] == 0).all())


@pytest.mark.gpu
def test_stats_route_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v, lengths = _inputs((2, 128, 8, 2, 64), "bfloat16", cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dec_ops.decode_attention_partial(q, k[:, ::2], v[:, ::2], lengths)
    qg = q.float().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        dec_ops.decode_attention_partial(qg, k.float(), v.float(), lengths)
