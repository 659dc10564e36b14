"""The port's attention ops against the JAX package's: each plain PyTorch
version (the CPU route of the op) against the JAX reference and against the
Pallas kernel in interpret mode, on the same numpy inputs; the ops' device
routing, launch counts and shape checks, and the kernels' launch limits.
The CUDA kernels themselves are held against the plain versions in
test_torch_attention_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import (
    decode_attention_reference as jax_decode_reference)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import (
    attention_reference as jax_attention_reference)
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

torch.set_num_threads(1)

# tests/test_kernels.py's tolerances for the same kernels against the same
# oracles: f32 sums in another order differ in the last digits, bf16
# outputs keep ~3 significant digits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, KV, D, block_q, block_k): tests/test_kernels.py's three
# shapes, D = 80 (zamba2, hubert) and a chunked continuation Sq < Skv
FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 32, 64, 64),
    (2, 256, 256, 4, 2, 32, 128, 64),
    (1, 128, 128, 8, 2, 64, 64, 128),
    (1, 128, 128, 4, 2, 80, 64, 64),
    (1, 64, 256, 4, 2, 32, 64, 64),
]
# (B, S, H, KV, D, block_k): tests/test_kernels.py's two shapes and D = 80;
# lengths are drawn ragged in 1..S
DECODE_SHAPES = [
    (3, 256, 4, 2, 32, 64),
    (2, 128, 8, 8, 64, 128),
    (3, 128, 4, 2, 80, 64),
]


def _mk(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_jax(dtype, causal, shape):
    B, Sq, Skv, H, KV, D, bq, bk = shape
    rng = np.random.default_rng(1)
    q, k, v = _mk(rng, (B, Sq, H, D)), _mk(rng, (B, Skv, KV, D)), \
        _mk(rng, (B, Skv, KV, D))
    before = fa_ops.invocation_count()
    got = fa_ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                                 _torch(v, dtype), causal=causal)
    assert fa_ops.invocation_count() == before + 1     # the CPU call counts
    assert got.shape == (B, Sq, H, D) and got.dtype == getattr(torch, dtype)
    jq, jk, jv = _jax(q, dtype), _jax(k, dtype), _jax(v, dtype)
    _close(got, jax_attention_reference(jq, jk, jv, causal=causal), dtype)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal, block_q=bq,
                                       block_k=bk, interpret=True), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_lengths(causal):
    """Sq and Skv that are no multiple of any tile (the Pallas kernel
    asserts divisibility; the reference takes them)."""
    rng = np.random.default_rng(2)
    q, k, v = _mk(rng, (2, 37, 4, 24)), _mk(rng, (2, 100, 1, 24)), \
        _mk(rng, (2, 100, 1, 24))
    got = fa_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), causal=causal)
    want = jax_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plain_matches_jax(dtype, shape):
    B, S, H, KV, D, bk = shape
    rng = np.random.default_rng(3)
    q, kc, vc = _mk(rng, (B, H, D)), _mk(rng, (B, S, KV, D)), \
        _mk(rng, (B, S, KV, D))
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    before = dec_ops.invocation_count()
    got = dec_ops.decode_attention(_torch(q, dtype), _torch(kc, dtype),
                                   _torch(vc, dtype), torch.tensor(lens))
    assert dec_ops.invocation_count() == before + 1
    assert got.shape == (B, H, D) and got.dtype == getattr(torch, dtype)
    jq, jk, jv = _jax(q, dtype), _jax(kc, dtype), _jax(vc, dtype)
    jl = jnp.asarray(lens)
    _close(got, jax_decode_reference(jq, jk, jv, jl), dtype)
    _close(got, decode_attention_pallas(jq, jk, jv, jl, block_k=bk,
                                        interpret=True), dtype)


def test_meta_tensors_raise_and_are_not_counted():
    fa_before, dec_before = fa_ops.invocation_count(), \
        dec_ops.invocation_count()
    q = torch.empty(1, 8, 4, 16, device="meta")
    kv = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(RuntimeError, match="device meta"):
        fa_ops.flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="device meta"):
        dec_ops.decode_attention(q[:, 0], kv, kv,
                                 torch.ones(1, dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        fa_ops.flash_attention(torch.zeros(1, 8, 4, 16), kv, kv)
    assert fa_ops.invocation_count() == fa_before
    assert dec_ops.invocation_count() == dec_before


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "batch", "groups",
                                 "causal_rows"])
def test_flash_rejects_bad_shapes(bad):
    q, k, v = torch.zeros(2, 16, 4, 16), torch.zeros(2, 16, 2, 16), \
        torch.zeros(2, 16, 2, 16)
    causal = True
    if bad == "rank":
        q = q[:, 0]
    elif bad == "kv_shape":
        v = v[:, :8]
    elif bad == "batch":
        k, v = k[:1], v[:1]
    elif bad == "groups":
        q = torch.zeros(2, 16, 3, 16)
    else:
        q = torch.zeros(2, 32, 4, 16)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("bad", ["rank", "head_dim", "groups", "lengths"])
def test_decode_rejects_bad_shapes(bad):
    q, kc = torch.zeros(2, 4, 16), torch.zeros(2, 32, 2, 16)
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "rank":
        q = q[None]
    elif bad == "head_dim":
        q = torch.zeros(2, 4, 8)
    elif bad == "groups":
        q = torch.zeros(2, 3, 16)
    else:
        lens = lens[:1]
    with pytest.raises(ValueError):
        dec_ops.decode_attention(q, kc, kc, lens)


def test_kernel_launch_limits():
    """What the kernels cannot take raises before any launch: head dims
    that are no multiple of 8 or above 128, groups above 16."""
    for d in (16, 64, 80, 128):
        fa_kernel.check_launch(d)
        dec_kernel.check_launch(2, d)
        assert fa_kernel.smem_bytes(d) <= fa_kernel.MAX_SMEM_BYTES
        assert dec_kernel.smem_bytes(dec_kernel.MAX_GROUP, d) \
            <= dec_kernel.MAX_SMEM_BYTES
    for d in (4, 20, 136, 256):
        with pytest.raises(ValueError, match="multiple of 8"):
            fa_kernel.check_launch(d)
        with pytest.raises(ValueError, match="multiple of 8"):
            dec_kernel.check_launch(2, d)
    dec_kernel.check_launch(7, 128)                  # qwen2-vl: 28 / 4
    with pytest.raises(ValueError, match="query heads per KV head"):
        dec_kernel.check_launch(dec_kernel.MAX_GROUP + 1, 64)
