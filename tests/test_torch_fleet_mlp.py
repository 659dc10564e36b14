"""The port's ``fleet_mlp`` against the JAX package's: the plain PyTorch
version (the CPU route of the wrapper) against ``fleet_mlp_reference`` and
against the Pallas kernel in interpret mode, on the same numpy inputs; the
wrapper's device routing and launch checks. The CUDA kernel itself is
held against the plain version in test_torch_fleet_mlp_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fleet_mlp.kernel import fleet_mlp_pallas
from repro.kernels.fleet_mlp.ops import fleet_mlp as jax_fleet_mlp
from repro.kernels.fleet_mlp.ref import fleet_mlp_reference
from repro_torch.kernels.common import KERNEL, PLAIN, resolve
from repro_torch.kernels.fleet_mlp import ops
from repro_torch.kernels.fleet_mlp.kernel import (MAX_DEPTH, MAX_SMEM_BYTES,
                                                  check_launch, smem_bytes)

torch.set_num_threads(1)

# TOL[dtype] * 10, the tolerance tests/test_kernels.py pins for the Pallas
# kernel against the same oracle: bf16 inputs carry ~3 significant digits
# and sums taken in another order differ in the last of them.
TOL = {"float32": 2e-4, "bfloat16": 2e-1}

# (N, b, F, hidden, depth): the three shapes of tests/test_kernels.py plus
# a ragged N that is no multiple of any block size
SHAPES = [(16, 4, 8, 32, 3), (8, 1, 54, 64, 5), (4, 2, 16, 16, 1),
          (5, 3, 12, 24, 4)]
BLOCK_N = {16: 4, 8: 8, 4: 2}


def _inputs(seed, N, b, F, Hd, depth):
    rng = np.random.default_rng(seed)
    sizes = [F] + [Hd] * (depth - 1) + [1]
    x = rng.normal(size=(N, b, F)).astype(np.float32)
    ws = [rng.normal(size=(N, sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(depth)]
    bs = [rng.normal(size=(N, sizes[i + 1])).astype(np.float32)
          for i in range(depth)]
    return x, ws, bs


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.tensor(a, device=device).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(dtype, shape):
    x, ws, bs = _inputs(1, *shape)
    before = ops.invocation_count()
    got = ops.fleet_mlp(_torch(x, dtype), [_torch(w, dtype) for w in ws],
                        [_torch(b, dtype) for b in bs])
    assert ops.invocation_count() == before + 1     # the CPU call counts
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (shape[0], shape[1], 1)
    got = got.float().numpy()
    jx, jws, jbs = _jax(x, dtype), [_jax(w, dtype) for w in ws], \
        [_jax(b, dtype) for b in bs]
    want = np.asarray(fleet_mlp_reference(jx, jws, jbs), np.float32)
    N = shape[0]
    if N in BLOCK_N:
        pallas = fleet_mlp_pallas(jx, jws, jbs, block_n=BLOCK_N[N],
                                  interpret=True)
    else:       # ragged: the JAX op zero-pads N up to its block multiple
        pallas = jax_fleet_mlp(jx, jws, jbs, impl="pallas_interpret",
                               block_n=2)
    pallas = np.asarray(pallas, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_resolve_routes_by_device():
    cpu = torch.zeros(1)
    assert resolve(cpu) == PLAIN
    assert resolve(cpu, cpu) == PLAIN
    assert KERNEL != PLAIN
    with pytest.raises(RuntimeError):
        resolve(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        resolve(cpu, torch.zeros(1, device="meta"))


def test_meta_tensor_raises_and_is_not_counted():
    x, ws, bs = _inputs(2, 4, 1, 8, 16, 3)
    meta = [torch.empty(a.shape, device="meta") for a in (x, *ws, *bs)]
    before = ops.invocation_count()
    with pytest.raises(RuntimeError, match="device meta"):
        ops.fleet_mlp(meta[0], meta[1:4], meta[4:])
    assert ops.invocation_count() == before


@pytest.mark.parametrize("bad", ["x_rank", "chain", "bias", "count"])
def test_wrapper_rejects_bad_layers(bad):
    x, ws, bs = _inputs(3, 4, 2, 8, 16, 3)
    x, ws, bs = (torch.tensor(x), [torch.tensor(w) for w in ws],
                 [torch.tensor(b) for b in bs])
    if bad == "x_rank":
        x = x[:, 0]
    elif bad == "chain":
        ws[1] = ws[1][:, :-1]
    elif bad == "bias":
        bs[0] = bs[0][:, :-1]
    else:
        bs = bs[:-1]
    with pytest.raises(ValueError):
        ops.fleet_mlp(x, ws, bs)


def test_launch_limits():
    """What the kernel cannot hold raises before any launch: depth above
    its maximum, and a rows x width product beyond a block's shared
    memory (never truncated)."""
    check_launch(1, [54, 512, 512, 512, 512, 1])     # the scoring shape
    assert smem_bytes(1, [54, 512, 1]) <= MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="depth"):
        check_launch(1, [8] * (MAX_DEPTH + 2))
    with pytest.raises(ValueError, match="shared memory"):
        check_launch(64, [54, 1024, 1])
