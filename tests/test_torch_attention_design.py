"""The arithmetic of the Hopper attention kernels' designs, modelled in
plain PyTorch on the CPU (the kernels themselves run only on a card, in
test_torch_attention_gpu.py):

* ``decode_attention``'s split-KV passes: each split's partial (m, l, o)
  over its range of cache slots, then the combine pass's rescale, at the
  split counts the wrapper chooses (``kernel.split_plan``), held against
  the port's and the JAX package's ``decode_attention_reference``;
* ``flash_attention``'s bf16 route: an online softmax over 128-key tiles
  whose probabilities are rounded to bf16 before the PV product (wgmma
  takes its A operand in bf16) while the row sums keep them in f32, held
  against ``attention_reference`` (probabilities in f32);
* the launch geometry of both routes of both kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import (
    decode_attention_reference as jax_decode_reference)
from repro.kernels.flash_attention.ref import (
    attention_reference as jax_attention_reference)
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_reference

torch.set_num_threads(1)

# tests/test_kernels.py's tolerances, on |got - ref| (atol and rtol): f32
# sums in another order differ in the last digits; bf16 outputs keep ~3
# significant digits, and the references round p to bf16 at other points
# than the models do (about one bf16 ulp)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def split_kv_model(q, k_cache, v_cache, lengths, n_split, split_len):
    """decode_attention's two passes in plain PyTorch: the partial pass
    over each split's slots ``[s * split_len, min(len, (s + 1) *
    split_len))`` (nothing at or past a row's length is read), then the
    combine pass. f32 throughout, one rounding at the end."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, D)
    m = torch.full((B, KV, n_split, G), -torch.inf)
    l = torch.zeros(B, KV, n_split, G)
    o = torch.zeros(B, KV, n_split, G, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        for s in range(n_split):
            c0, c1 = s * split_len, min(n, (s + 1) * split_len)
            if c0 >= c1:        # the block writes m = -inf, l = 0 and exits
                continue
            k = k_cache[b, c0:c1].float()
            v = v_cache[b, c0:c1].float()
            sc = torch.einsum("kgd,ckd->kgc", qf[b], k) * D ** -0.5
            m[b, :, s] = sc.amax(-1)
            p = torch.exp(sc - m[b, :, s, :, None])
            l[b, :, s] = p.sum(-1)
            o[b, :, s] = torch.einsum("kgc,ckd->kgd", p, v)
    m_max = m.amax(2, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0,
                    torch.exp(m - torch.where(m_max == -torch.inf, 0.0, m_max)))
    den = (w * l).sum(2)
    num = (w[..., None] * o).sum(2)
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None],
                      0.0)
    return out.reshape(B, H, D).to(q.dtype)


def _edge_lengths(B, S, split_len):
    """0, 1, on a split boundary, one past it, S and above S, cycled."""
    pool = [0, 1, split_len, split_len + 1, min(2 * split_len, S), S, S + 9,
            split_len - 1]
    return np.array([pool[i % len(pool)] for i in range(B)], np.int32)


# (B, S, H, KV, D): the split plans of the qwen3-1.7b engine (8 x 2048, 8
# KV heads: 8 splits of 256) and zamba2-2.7b's (4 x 512, 32 KV heads: 2
# of 256) at a narrow head dim, and a small shape (4 splits of 64)
SPLIT_SHAPES = [(8, 2048, 16, 8, 16), (4, 512, 32, 32, 16), (3, 256, 4, 2, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_kv_model_matches_references(dtype, shape):
    B, S, H, KV, D = shape
    n_split, split_len = dec_kernel.split_plan(B, KV, S)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    lens = _edge_lengths(B, S, split_len)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(dt) for a in (q, kc, vc))
    # garbage (NaN) at and past every length never reaches the model
    nk, nv = tk.clone(), tv.clone()
    for b, n in enumerate(lens):
        nk[b, min(n, S):] = float("nan")
        nv[b, min(n, S):] = float("nan")
    got = split_kv_model(tq, nk, nv, lens, n_split, split_len)
    assert got.shape == (B, H, D) and got.dtype == dt
    assert bool(torch.isfinite(got.float()).all())
    live = torch.tensor(lens > 0)
    assert bool((got[~live] == 0).all())               # length 0: zeros
    # the references (no NaNs, lengths of at least 1) on the live rows
    safe = torch.tensor(np.maximum(lens, 1))
    want = decode_attention_reference(tq, tk, tv, safe)
    jdt = getattr(jnp, dtype)
    jwant = jax_decode_reference(*(jnp.asarray(a).astype(jdt)
                                   for a in (q, kc, vc)),
                                 jnp.asarray(np.maximum(lens, 1)))
    tol = TOL[dtype]
    np.testing.assert_allclose(got[live].float().numpy(),
                               want[live].float().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(got[live].float().numpy(),
                               np.asarray(jwant, np.float32)[lens > 0],
                               atol=tol, rtol=tol)


def bf16_p_attention(q, k, v, *, causal, block_k=128):
    """flash_attention's bf16 route in plain PyTorch: an online softmax
    over ``block_k``-key tiles in the log2 domain, each tile's
    probabilities rounded to bf16 before the PV product, the running sum
    kept from the unrounded f32 probabilities, O in f32."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = D ** -0.5 * 1.4426950408889634
    qf = q.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, KV, G, Sq), -torch.inf)
    l = torch.zeros(B, KV, G, Sq)
    o = torch.zeros(B, KV, G, Sq, D)
    for k0 in range(0, Skv, block_k):
        cols = torch.arange(k0, min(Skv, k0 + block_k))
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kf[:, cols]) * c
        if causal:
            s = torch.where(cols[None, :] <= rows, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)
        pb = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", pb,
                                                vf[:, cols])
        m = m_new
    out = o / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [80, 128])
def test_bf16_probabilities_stay_within_bf16_tolerance(seed, causal, D):
    """Rounding P to bf16 before PV (the wgmma route) moves the output by
    about one bf16 ulp against the f32-P plain version: inside 2e-2."""
    rng = np.random.default_rng(seed)
    B, Sq, Skv, H, KV = 1, 192, 256, 4, 2
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    got = bf16_p_attention(tq, tk, tv, causal=causal)
    want = attention_reference(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=tol)
    jwant = jax_attention_reference(*(jnp.asarray(a).astype(jnp.bfloat16)
                                      for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jwant, np.float32), atol=tol,
                               rtol=tol)
    # and in f32 the model is the plain version's algorithm, rounding aside
    f32 = bf16_p_attention(*(torch.tensor(a) for a in (q, k, v)),
                           causal=causal)
    ref32 = attention_reference(*(torch.tensor(a) for a in (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(f32.numpy(), ref32.numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_shared_memory_of_every_route_fits(D):
    """One block of each route fits the 232,448 bytes a block may hold."""
    for dtype in (torch.bfloat16, torch.float32):
        fa_kernel.check_launch(D, dtype)
        assert fa_kernel.smem_bytes(D, dtype) <= fa_kernel.MAX_SMEM_BYTES
        dec_kernel.check_launch(dec_kernel.MAX_GROUP, D, dtype)
        assert dec_kernel.smem_bytes(dec_kernel.MAX_GROUP, D, dtype) \
            <= dec_kernel.MAX_SMEM_BYTES
    # the bf16 route's tiles: one 64-column atom up to D 64, two above
    atoms = 1 if D <= 64 else 2
    assert fa_kernel.smem_bytes(D) == 1024 + atoms * (
        2 * fa_kernel.Q_ATOM_BYTES
        + 2 * fa_kernel.STAGES * fa_kernel.KV_ATOM_BYTES) \
        + 8 * (2 * fa_kernel.STAGES + 1)


def test_split_plan_fills_the_card_from_shapes_alone():
    """The engine shape takes 8 splits of 256 slots (512 blocks), zamba2's
    2 (256 blocks); fewer (row, KV head) pairs take shorter splits, down to
    one 64-slot tile; the ranges always cover the cache."""
    assert dec_kernel.split_plan(8, 8, 2048) == (8, 256)
    assert dec_kernel.split_plan(4, 32, 512) == (2, 256)
    assert dec_kernel.split_plan(3, 2, 256) == (4, 64)
    assert dec_kernel.split_plan(1, 1, 40) == (1, 64)
    for B, KV, S in [(8, 8, 2048), (4, 32, 512), (2, 4, 300), (1, 8, 4096),
                     (16, 8, 2048), (1, 1, 1)]:
        n, slots = dec_kernel.split_plan(B, KV, S)
        assert n * slots >= S > (n - 1) * slots
        assert slots % dec_kernel.BLOCK_K == 0
        assert slots == dec_kernel.BLOCK_K or \
            B * KV * n >= dec_kernel.TARGET_BLOCKS
