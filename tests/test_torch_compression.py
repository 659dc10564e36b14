"""The port's int8 gradient compression with error feedback against the
JAX package's (``repro.distributed.compression``) on seeded f32 inputs:
the codes, the scales and the dequantised values, five rounds of
``compress_with_feedback`` over a tree, ``wire_bytes_saved``; and the
reference's own two properties (``tests/test_distributed.py``): the
quantisation error within half a scale, and error feedback unbiased over
64 rounds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _property_settings import UNTIMED
from repro.distributed import compression as JC
from repro_torch.distributed import compression as TC

torch.set_num_threads(1)


def _inputs(seed, n=4096, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * scale).astype(np.float32)


def _near_ties(x, scale) -> int:
    """Elements whose x / scale lies within one f32 ulp of k + 1/2, where
    two correct f32 roundings may pick different codes."""
    q = np.asarray(x, np.float32) / np.float32(scale)
    frac = np.abs(q - np.floor(q) - np.float32(0.5))
    return int((frac <= np.spacing(np.abs(q).astype(np.float32))).sum())


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e4),
                                        (3, 1e-20)])
def test_codes_and_scale_match_jax(seed, scale):
    x = _inputs(seed, scale=scale)
    jcodes, jscale = JC.quantize_int8(jnp.asarray(x))
    tcodes, tscale = TC.quantize_int8(torch.from_numpy(x))
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    assert float(tscale) == float(jscale)
    differ = tcodes.numpy() != np.asarray(jcodes)
    assert _near_ties(x, float(tscale)) == 0
    assert int(differ.sum()) == 0
    np.testing.assert_array_equal(
        TC.dequantize_int8(tcodes, tscale).numpy(),
        np.asarray(JC.dequantize_int8(jcodes, jscale)))


def test_all_zero_tensor():
    """amax + 1e-12 keeps the scale positive: zeros code to zeros."""
    codes, scale = TC.quantize_int8(torch.zeros(7))
    assert float(scale) > 0 and not codes.any()


def _tree(tree, make):
    """``make`` on every leaf of a dict tree (shapes or arrays)."""
    if isinstance(tree, dict):
        return {k: _tree(v, make) for k, v in tree.items()}
    return make(tree)


def _pairs(a, b):
    if isinstance(a, dict):
        return [p for k in sorted(a) for p in _pairs(a[k], b[k])]
    return [(a, b)]


def test_feedback_rounds_match_jax():
    """Five rounds over a tree of three leaves: the compressed gradients
    and the error states; a bf16 gradient comes back in bf16 with an f32
    error."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 32), "b": {"c": (128,), "d": (8, 8, 4)}}
    je = JC.init_error_state(_tree(shapes, jnp.zeros))
    te = TC.init_error_state(_tree(shapes, torch.zeros))
    for _ in range(5):
        g = _tree(shapes, lambda s: rng.normal(size=s).astype(np.float32))
        jg, je = JC.compress_with_feedback(_tree(g, jnp.asarray), je)
        tg, te = TC.compress_with_feedback(_tree(g, torch.from_numpy), te)
        for t, j in _pairs(tg, jg) + _pairs(te, je):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    bf = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    out, err = TC.compress_with_feedback({"w": bf.to(torch.bfloat16)},
                                         {"w": torch.zeros(16)})
    assert out["w"].dtype == torch.bfloat16 and err["w"].dtype == torch.float32


def test_wire_bytes_saved_matches_jax():
    shapes = [(64, 32), (128,), (8, 8, 4), (3,)]
    jt = {f"p{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    tt = {f"p{i}": torch.zeros(s) for i, s in enumerate(shapes)}
    assert TC.wire_bytes_saved(tt) == JC.wire_bytes_saved(jt)
    n = sum(int(np.prod(s)) for s in shapes)
    assert TC.wire_bytes_saved(tt) == 3 * n - 4 * len(shapes)


@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1,
                max_size=200))
@settings(max_examples=50, **UNTIMED)
def test_quantize_error_bounded_by_half_scale(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    codes, scale = TC.quantize_int8(x)
    err = torch.abs(TC.dequantize_int8(codes, scale) - x)
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.from_numpy(
        np.random.default_rng(1).normal(size=512).astype(np.float32))}
    e = TC.init_error_state(g)
    acc = torch.zeros(512)
    for _ in range(64):
        cg, e = TC.compress_with_feedback(g, e)
        acc = acc + cg["w"]
    np.testing.assert_allclose((acc / 64).numpy(), g["w"].numpy(), atol=2e-3)


def test_feedback_hook_threads_the_error_and_frees_it():
    """``FeedbackHook`` as a ``grad_hook``: three calls equal three rounds
    of ``compress_with_feedback`` threading the error by hand; the error
    state dies with the hook at once, with the cycle collector off (a
    model-sized state kept until it ran cost a card its headroom)."""
    import gc
    import weakref
    rng = np.random.default_rng(9)
    grads = [{"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(
        np.float32))} for _ in range(3)]
    hook, e = TC.FeedbackHook(), TC.init_error_state(grads[0])
    for g in grads:
        want, e = TC.compress_with_feedback(g, e)
        assert torch.equal(hook(g)["w"], want["w"])
        assert torch.equal(hook.error["w"], e["w"])
    ref = weakref.ref(hook.error["w"])
    gc.disable()
    try:
        del hook
        assert ref() is None
    finally:
        gc.enable()
