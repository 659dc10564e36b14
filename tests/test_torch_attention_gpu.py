"""The hand-written CUDA ``flash_attention`` and ``decode_attention``
kernels against their plain PyTorch versions on the card, at the unit-test
shapes of tests/test_kernels.py, head dims 16, 80 and 128, Sq < Skv,
ragged lengths, GQA groups 5, 6, 7 and 9 at D 128, and the serving
path's shapes (qwen3-1.7b, zamba2-2.7b, hubert-xlarge's non-causal D 80,
dbrx-132b's group 6, llama4-maverick's group 5). f32 inputs exercise flash_attention's
CUDA-core route, bf16 its wgmma route; decode lengths on and around the
split-KV boundaries. Imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_reference

# tests/test_kernels.py's tolerances for the Pallas kernels: f32 sums taken
# in another order differ in the last digits; bf16 outputs round to ~3
# significant digits (and the decode reference rounds p to bf16 as well)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, KV, D)
FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 32), (2, 256, 256, 4, 2, 32), (1, 128, 128, 8, 2, 64),
    (2, 64, 64, 4, 2, 16), (1, 96, 96, 4, 4, 80), (1, 64, 256, 4, 2, 32),
    (2, 37, 200, 4, 1, 80), (1, 100, 100, 16, 8, 128),
    (4, 1024, 1024, 16, 8, 128),       # qwen3-1.7b prefill
    (4, 1024, 1024, 32, 32, 80),       # zamba2-2.7b's shared attention block
    (2, 500, 500, 16, 16, 80),         # hubert-xlarge (its encoder is non-causal)
    # GQA groups 5, 6, 7 and 9 at D 128 (llama4-maverick, dbrx-132b and
    # internlm2-20b, qwen2-vl-7b, starcoder2-7b)
    (1, 128, 128, 40, 8, 128), (2, 96, 160, 48, 8, 128),
    (1, 200, 200, 28, 4, 128), (2, 64, 64, 36, 4, 128),
    (4, 1024, 1024, 48, 8, 128),       # dbrx-132b prefill
    (4, 1024, 1024, 40, 8, 128),       # llama4-maverick prefill
]
# (B, S, H, KV, D)
DECODE_SHAPES = [
    (3, 256, 4, 2, 32), (2, 128, 8, 8, 64), (2, 96, 4, 2, 16),
    (3, 200, 4, 4, 80), (2, 300, 28, 4, 128),
    (8, 2048, 16, 8, 128),             # qwen3-1.7b serving, 8 slots
    (4, 512, 32, 32, 80),              # zamba2-2.7b serving, group 1
    # GQA groups 5, 6 and 9 at D 128 (group 7 is the (2, 300, 28, 4) case)
    (2, 256, 40, 8, 128), (3, 300, 48, 8, 128), (2, 200, 36, 4, 128),
    (4, 512, 48, 8, 128),              # dbrx-132b serving, group 6
    (4, 512, 40, 8, 128),              # llama4-maverick serving, group 5
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(g, shape, dtype, device):
    return torch.randn(shape, generator=g, device=device).to(getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, causal, shape):
    B, Sq, Skv, H, KV, D = shape
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = _randn(g, (B, Sq, H, D), dtype, cuda_device)
    k = _randn(g, (B, Skv, KV, D), dtype, cuda_device)
    v = _randn(g, (B, Skv, KV, D), dtype, cuda_device)
    before = fa_ops.invocation_count()
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.invocation_count() == before + 1
    want = attention_reference(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == q.dtype
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    B, S, H, KV, D = shape
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = _randn(g, (B, H, D), dtype, cuda_device)
    kc = _randn(g, (B, S, KV, D), dtype, cuda_device)
    vc = _randn(g, (B, S, KV, D), dtype, cuda_device)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    lengths[0] = S                      # one full row, the rest ragged
    before = dec_ops.invocation_count()
    got = dec_ops.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert dec_ops.invocation_count() == before + 1
    want = decode_attention_reference(q, kc, vc, lengths)
    assert got.shape == want.shape and got.dtype == q.dtype
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _edge_lengths(case, B, S, split_len):
    """Lengths on and around the split boundaries of ``split_plan``."""
    if case == "boundaries":
        cuts = list(range(split_len, S + 1, split_len)) or [S]
        return [cuts[i % len(cuts)] for i in range(B)]
    if case == "ones":
        return [1] * B
    if case == "full":
        return [S] * B
    return [0] + [split_len + 1, S + 5, split_len - 1][:B - 1]   # "zero"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["boundaries", "ones", "full", "zero"])
@pytest.mark.parametrize("shape", [(4, 512, 32, 32, 80), (4, 2048, 16, 8, 128),
                                   (3, 200, 4, 2, 32)])
def test_decode_kernel_split_edges_on_card(cuda_device, dtype, case, shape):
    """Every length on a split boundary, all 1, all S, and a row of 0 (with
    one above S, which counts as S): the partial pass's empty splits and
    the combine pass's rescale against the plain version."""
    B, S, H, KV, D = shape
    _, split_len = dec_kernel.split_plan(B, KV, S)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = _randn(g, (B, H, D), dtype, cuda_device)
    kc = _randn(g, (B, S, KV, D), dtype, cuda_device)
    vc = _randn(g, (B, S, KV, D), dtype, cuda_device)
    lengths = torch.tensor(_edge_lengths(case, B, S, split_len),
                           dtype=torch.int32, device=cuda_device)
    got = dec_ops.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, kc, vc, lengths.clamp(min=1))
    want = torch.where((lengths > 0)[:, None, None], want, 0)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_decode_ignores_slots_past_length(cuda_device):
    """Garbage (even NaN) in cache slots at and past a row's length never
    reaches its output."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = _randn(g, (2, 4, 32), "float32", cuda_device)
    kc = _randn(g, (2, 128, 2, 32), "float32", cuda_device)
    vc = _randn(g, (2, 128, 2, 32), "float32", cuda_device)
    lengths = torch.tensor([70, 1], dtype=torch.int32, device=cuda_device)
    want = dec_ops.decode_attention(q, kc, vc, lengths)
    kc[0, 70:] = float("nan")
    vc[1, 1:] = float("nan")
    got = dec_ops.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernels_reject_what_they_cannot_take(cuda_device):
    q = torch.zeros(1, 64, 4, 20, device=cuda_device)
    kv = torch.zeros(1, 64, 2, 20, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa_ops.flash_attention(q, kv, kv)
    q = torch.zeros(1, 64, 4, 32, device=cuda_device)
    kv = torch.zeros(1, 64, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               kv, kv)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), kv.half(), kv.half())
    qd = torch.zeros(2, 34, 32, device=cuda_device)
    kc = torch.zeros(2, 16, 2, 32, device=cuda_device)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="query heads per KV head"):
        dec_ops.decode_attention(qd, kc, kc, lengths)
    with pytest.raises(TypeError, match="int32"):
        dec_ops.decode_attention(torch.zeros(2, 4, 32, device=cuda_device),
                                 kc, kc, lengths.long())
