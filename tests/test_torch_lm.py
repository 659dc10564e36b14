"""The port's language model against the JAX package's, on the six
pure-attention smoke configs, the two recurrent ones (zamba2-2.7b's
Mamba2 hybrid with its shared block, rwkv6-7b) and the two MoE ones
(dbrx-132b, llama4-maverick's dense / MoE alternation with its shared
expert; their routes held equal layer by layer): the JAX parameters from
``M.init_params(cfg, PRNGKey(0))`` cross as numpy through
``params_from_numpy``, and both packages compute ``forward`` (train and
prefill) and ``decode_step`` on the same tokens. f32 where the point is
the algorithm; bf16 cases at a looser, stated tolerance."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import model as JM
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro_torch.arch import layers
from repro_torch.arch import model as TM
from repro_torch.arch.params import cast_tree, params_from_numpy, tree_leaves
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

torch.set_num_threads(1)

ATTN_ARCHS = ["qwen3-1.7b", "llama3-8b", "starcoder2-7b", "internlm2-20b",
              "qwen2-vl-7b", "hubert-xlarge"]
DECODERS = [a for a in ATTN_ARCHS if a != "hubert-xlarge"]
RECURRENT_ARCHS = ["zamba2-2.7b", "rwkv6-7b"]
MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
# f32: the two packages run the same f32 arithmetic in other orders (XLA's
# fused dots against ATen's GEMMs); after two layers the logits agree to a
# few ulps of their largest entry
F32_TOL = 2e-5
# bf16: the packages round to bf16 at other places inside attention (the
# JAX CPU path casts the probabilities to bf16 before p.v, the port keeps
# them f32, as the kernels do), one bf16 ulp is 2^-8 = 3.9e-3 relative;
# logits agree to a few ulps of their largest entry
BF16_TOL = 2e-2
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port params) of an arch's smoke
    config, with the same f32 parameter values on both sides."""
    jcfg = jax_get_config(arch + "-smoke").replace(dtype=dtype)
    tcfg = get_config(arch + "-smoke").replace(dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, seq=S):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        fr = rng.normal(size=(B, seq, cfg.d_model)).astype(np.float32)
        return {"frames": jnp.asarray(fr)}, {"frames": torch.tensor(fr)}
    tk = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(tk)}, {"tokens": torch.tensor(tk)}


def _rel_max(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def test_configs_match_jax():
    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        for name in (arch, arch + "-smoke"):
            assert dataclasses.asdict(get_config(name)) == \
                dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_param_tree_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = tree_leaves(tp)
    assert [l.shape for l in jleaves] == [tuple(t.shape) for t in tleaves]
    assert TM.param_count(tcfg) == JM.param_count(jcfg)
    assert TM.param_count(get_config(arch)) == \
        JM.param_count(jax_get_config(arch))
    g = torch.Generator().manual_seed(0)
    own = TM.init_params(tcfg, g, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tleaves]
    half = cast_tree(own, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(half))
    assert all(torch.equal(a.to(torch.bfloat16), b)
               for a, b in zip(tree_leaves(own), tree_leaves(half)))


def test_qwen3_full_width_sizes():
    cfg = get_config("qwen3-1.7b")
    assert TM.param_count(cfg) == 1_720_574_976
    spec = TM.decode_state_specs(cfg, 8, 2048)
    k = spec["caches"]["pos0"]["k"]
    assert k.shape == (28, 8, 2048, 8, 128) and k.dtype == torch.bfloat16
    per_token = 2 * 28 * 8 * 128 * 2
    assert per_token == 114_688


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_train_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 1)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    before = fa_ops.invocation_count()
    got, aux = TM.forward(tcfg, tp, tb, mode="train")
    assert fa_ops.invocation_count() == before + tcfg.num_layers
    assert aux == {} and got.dtype == torch.float32
    assert got.shape == (B, S, tcfg.vocab_size)
    assert _rel_max(got, want) < F32_TOL


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 2)
    want, jstate = JM.forward(jcfg, jp, jb, mode="prefill", remat=False)
    got, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert got.shape == (B, tcfg.vocab_size)
    assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].dtype == torch.int32
    assert state["lengths"].tolist() == [S] * B
    for name in ("k", "v"):
        jc = np.asarray(jstate["caches"]["pos0"][name])
        tc = state["caches"]["pos0"][name]
        assert tuple(tc.shape) == jc.shape == (
            tcfg.num_periods, B, S, tcfg.num_kv_heads, tcfg.head_dim)
        assert _rel_max(tc, jc) < F32_TOL
    hidden, _ = TM.forward(tcfg, tp, tb, mode="hidden")
    jh, _ = JM.forward(jcfg, jp, jb, mode="hidden", remat=False)
    assert hidden.shape == (B, S, tcfg.d_model)
    assert _rel_max(hidden, jh) < F32_TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_jax(arch):
    """Three decode steps from a zeroed state: logits at every step, then
    the caches and lengths."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jstate = JM.init_decode_state(jcfg, B, 8)
    state = TM.init_decode_state(tcfg, B, 8, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jstate = JM.decode_step(jcfg, jp, jstate,
                                      {"tokens": jnp.asarray(tok)})
        got, state = TM.decode_step(tcfg, tp, state,
                                    {"tokens": torch.tensor(tok)})
        assert got.shape == (B, tcfg.vocab_size)
        assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == np.asarray(jstate["lengths"]).tolist()
    for name in ("k", "v"):
        assert _rel_max(state["caches"]["pos0"][name],
                        jstate["caches"]["pos0"][name]) < F32_TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(x[:-1]), x[-1]) == forward(x)[-1] inside the port, at
    the JAX package's own bound (tests/test_arch_smoke.py)."""
    _, tcfg, _, tp = _pair(arch)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = TM.forward(tcfg, tp, {"tokens": toks}, mode="train")
    _, state = TM.forward(tcfg, tp, {"tokens": toks[:, :S - 1]},
                          mode="prefill")
    grow = lambda c: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))  # noqa: E731
    state = {"caches": {k: {n: grow(c) for n, c in v.items()}
                        for k, v in state["caches"].items()},
             "lengths": state["lengths"]}
    got, _ = TM.decode_step(tcfg, tp, state, {"tokens": toks[:, S - 1:]})
    rel = float((got - full[:, -1]).abs().max()
                / (full[:, -1].abs().max() + 1e-9))
    assert rel < 2e-3, f"{arch}: prefill+decode rel err {rel}"


def test_decode_rows_leave_other_rows_exact():
    """``rows`` writes only those batch rows' caches; the others keep every
    byte."""
    _, tcfg, _, tp = _pair("qwen3-1.7b")
    state = TM.init_decode_state(tcfg, 3, 8, device="cpu")
    for c in tree_leaves(state["caches"]):
        c.normal_(generator=torch.Generator().manual_seed(0))
    before = [c.clone() for c in tree_leaves(state["caches"])]
    state["lengths"] = torch.tensor([2, 5, 1], dtype=torch.int32)
    TM.decode_step(tcfg, tp, state, {"tokens": torch.ones(3, 1, dtype=torch.long)},
                   rows=torch.tensor([1]))
    for old, new in zip(before, tree_leaves(state["caches"])):
        assert torch.equal(old[:, [0, 2]], new[:, [0, 2]])
        assert not torch.equal(old[:, 1, 5], new[:, 1, 5])
        assert torch.equal(old[:, 1, :5], new[:, 1, :5])


def test_bf16_forward_matches_jax():
    """qwen3 smoke in its own compute dtype (bf16), f32 parameters cast at
    use on both sides."""
    jcfg, tcfg, jp, tp = _pair("qwen3-1.7b", "bfloat16")
    jb, tb = _batch(jcfg, 5)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    got, _ = TM.forward(tcfg, tp, tb, mode="train")
    assert _rel_max(got, want) < BF16_TOL
    jw, jstate = JM.forward(jcfg, jp, jb, mode="prefill", remat=False)
    tw, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert state["caches"]["pos0"]["k"].dtype == torch.bfloat16
    assert _rel_max(tw, jw) < BF16_TOL


def test_bf16_parameters_as_stored():
    """``init_params(..., dtype=bfloat16)`` stores bf16 leaves; the JAX
    function takes the same argument, so the same bf16 values give the same
    logits on both sides."""
    jcfg = jax_get_config("qwen3-1.7b-smoke")
    tcfg = get_config("qwen3-1.7b-smoke")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(own))
    jb, tb = _batch(jcfg, 6)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    got, _ = TM.forward(tcfg, tp, tb, mode="train")
    assert _rel_max(got, want) < BF16_TOL


def test_encoder_has_no_decode_and_dist_waits():
    cfg = get_config("hubert-xlarge-smoke")
    with pytest.raises(ValueError, match="encoder-only"):
        TM.decode_step(cfg, {}, {"lengths": torch.zeros(2, dtype=torch.int32)},
                       {})
    # the distributed flash-decode is ported (tests/test_torch_decode_
    # distributed.py); what the decode step still refuses is an unroll
    # lax.scan refuses
    with pytest.raises(ValueError, match="scan_unroll"):
        TM.decode_step(get_config("qwen3-1.7b-smoke"), {},
                       {"lengths": torch.zeros(2, dtype=torch.int32)}, {},
                       scan_unroll=0)


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("qwen3-1.7b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.init_decode_state(cfg, 1, 4)


def test_layer_numerics_match_jax():
    """The rounding points of the layers: layernorm (population variance),
    the qk-norm eps, M-RoPE's sections and the tanh gelu."""
    from repro.arch import layers as JL
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 5))
    for mrope in (False, True):
        p = pos if mrope else pos[0]
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e4, mrope=mrope)
        got = layers.apply_rope(torch.tensor(x), torch.tensor(p), 1e4,
                                mrope=mrope)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert layers.mrope_sections(128) == JL.mrope_sections(128) == (16, 24, 24)
    scale = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_head_norm(torch.tensor(scale), torch.tensor(x)).numpy(),
        JL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)), atol=1e-6,
        rtol=1e-5)
    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    for arch in ("hubert-xlarge", "qwen3-1.7b"):
        jcfg, tcfg, jp, tp = _pair(arch)
        lp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"])
        tl = {k: {n: t[0] for n, t in v.items()}
              for k, v in tp["blocks"]["pos0"].items()}
        np.testing.assert_allclose(
            layers.apply_norm(tcfg, tl["ln1"], torch.tensor(h)).numpy(),
            JL.apply_norm(jcfg, lp["ln1"], jnp.asarray(h)), atol=1e-5,
            rtol=1e-5)
        np.testing.assert_allclose(
            layers.mlp_block(tcfg, tl["mlp"], torch.tensor(h)).numpy(),
            JL.mlp_block(jcfg, lp["mlp"], jnp.asarray(h)), atol=1e-5,
            rtol=1e-5)


# ---------------------------------------------------------------- recurrent

def _scan_counts():
    return (fa_ops.invocation_count(), ssd_ops.invocation_count(),
            wkv_ops.invocation_count())


def _leaves(caches):
    """(key, name, tensor) of every cache leaf, in a fixed order."""
    return [(k, n, caches[k][n]) for k in sorted(caches)
            for n in sorted(caches[k])]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_param_tree_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    assert [l.shape for l in jax.tree_util.tree_leaves(jp)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    assert TM.param_count(tcfg) == JM.param_count(jcfg)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    assert ("shared" in tp) == (arch == "zamba2-2.7b")
    assert ("ln0" in tp) == (arch == "rwkv6-7b")


def test_recurrent_full_width_sizes():
    """The published widths: parameter counts and the engine's decode
    state at 4 slots x 512 positions."""
    zcfg, rcfg = get_config("zamba2-2.7b"), get_config("rwkv6-7b")
    assert TM.param_count(zcfg) == JM.param_count(
        jax_get_config("zamba2-2.7b")) == 2_494_764_960
    assert TM.param_count(rcfg) == JM.param_count(
        jax_get_config("rwkv6-7b")) == 7_576_756_224
    z = TM.decode_state_specs(zcfg, 4, 512)["caches"]
    assert z["shared"]["k"].shape == (9, 4, 512, 32, 80)
    assert z["pos0"]["conv"].shape == (9, 4, 3, 5120 + 2 * 64)
    assert z["pos0"]["conv"].dtype == torch.bfloat16
    assert z["pos5"]["ssd"].shape == (9, 4, 80, 64, 64)
    assert z["pos5"]["ssd"].dtype == torch.float32
    r = TM.decode_state_specs(rcfg, 4, 512)["caches"]
    assert set(r) == {"pos0"}
    assert r["pos0"]["wkv"].shape == (32, 4, 64, 64, 64)
    assert r["pos0"]["wkv"].dtype == torch.float32
    assert r["pos0"]["x_tm"].shape == r["pos0"]["x_cm"].shape == (32, 4, 4096)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_forward_train_matches_jax(arch):
    """Logits, and one scan launch per recurrent block and one
    flash_attention launch per application of the shared block."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 1)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    before = _scan_counts()
    got, aux = TM.forward(tcfg, tp, tb, mode="train")
    fa, ssd, wkv = (a - b for a, b in zip(_scan_counts(), before))
    P = tcfg.num_periods
    assert fa == P * int(tcfg.shared_attn_every_period)
    assert ssd == P * tcfg.pattern.count("mamba2")
    assert wkv == P * tcfg.pattern.count("rwkv6")
    assert ssd + wkv == tcfg.num_layers
    assert aux == {} and got.dtype == torch.float32
    assert got.shape == (B, S, tcfg.vocab_size)
    assert _rel_max(got, want) < F32_TOL


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_prefill_matches_jax(arch):
    """Last logits, every cache leaf (conv / ssd / shared k, v; x_tm / x_cm
    / wkv) with its shape and dtype, the lengths and the hidden states."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 2)
    want, jstate = JM.forward(jcfg, jp, jb, mode="prefill", remat=False)
    got, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert got.shape == (B, tcfg.vocab_size)
    assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == [S] * B
    specs = TM.decode_state_specs(tcfg, B, S)["caches"]
    leaves = _leaves(state["caches"])
    assert [(k, n) for k, n, _ in leaves] == \
        [(k, n) for k, n, _ in _leaves(specs)]
    for key, name, tc in leaves:
        jc = np.asarray(jstate["caches"][key][name])
        assert tuple(tc.shape) == jc.shape == specs[key][name].shape
        assert tc.dtype == specs[key][name].dtype
        assert _rel_max(tc, jc) < F32_TOL, (key, name)
    hidden, _ = TM.forward(tcfg, tp, tb, mode="hidden")
    jh, _ = JM.forward(jcfg, jp, jb, mode="hidden", remat=False)
    assert _rel_max(hidden, jh) < F32_TOL


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_decode_steps_match_jax(arch):
    """Four decode steps from a zeroed state: logits at every step, then
    every cache leaf and the lengths."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jstate = JM.init_decode_state(jcfg, B, 8)
    state = TM.init_decode_state(tcfg, B, 8, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jstate = JM.decode_step(jcfg, jp, jstate,
                                      {"tokens": jnp.asarray(tok)})
        got, state = TM.decode_step(tcfg, tp, state,
                                    {"tokens": torch.tensor(tok)})
        assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == np.asarray(jstate["lengths"]).tolist()
    for key, name, tc in _leaves(state["caches"]):
        assert _rel_max(tc, jstate["caches"][key][name]) < F32_TOL, (key, name)


def _grow(state, extra):
    """Room for ``extra`` more positions in the attention caches (dim 2 of
    the stacked k / v); recurrent states have no sequence axis."""
    pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, extra))  # noqa: E731
    return {"caches": {k: {n: pad(c) if n in ("k", "v") else c
                           for n, c in v.items()}
                       for k, v in state["caches"].items()},
            "lengths": state["lengths"]}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_prefill_decode_consistency(arch):
    """decode(prefill(x[:-1]), x[-1]) == forward(x)[-1] at the JAX
    package's own bound (tests/test_arch_smoke.py); and prefill of the
    first half then decode of the rest equals decode of every token from
    a zeroed state, logits and final states at F32_TOL."""
    _, tcfg, _, tp = _pair(arch)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = TM.forward(tcfg, tp, {"tokens": toks}, mode="train")
    _, state = TM.forward(tcfg, tp, {"tokens": toks[:, :S - 1]},
                          mode="prefill")
    got, _ = TM.decode_step(tcfg, tp, _grow(state, 1),
                            {"tokens": toks[:, S - 1:]})
    rel = float((got - full[:, -1]).abs().max()
                / (full[:, -1].abs().max() + 1e-9))
    assert rel < 2e-3, f"{arch}: prefill+decode rel err {rel}"

    half = S // 2
    _, state = TM.forward(tcfg, tp, {"tokens": toks[:, :half]},
                          mode="prefill")
    state = _grow(state, S - half)
    alone = TM.init_decode_state(tcfg, B, S, device="cpu")
    for i in range(S):
        want, alone = TM.decode_step(tcfg, tp, alone,
                                     {"tokens": toks[:, i:i + 1]})
        if i >= half:
            got, state = TM.decode_step(tcfg, tp, state,
                                        {"tokens": toks[:, i:i + 1]})
    assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == alone["lengths"].tolist() == [S] * B
    for (key, name, a), (_, _, b) in zip(_leaves(state["caches"]),
                                         _leaves(alone["caches"])):
        assert _rel_max(a, b) < F32_TOL, (key, name)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_decode_rows_leave_other_rows_exact(arch):
    """``rows`` writes only those batch rows' states: the other rows keep
    every byte of conv / ssd / x_tm / x_cm / wkv (and k / v); the written
    row's recurrent states change, its k / v only at its length."""
    _, tcfg, _, tp = _pair(arch)
    state = TM.init_decode_state(tcfg, 3, 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for c in tree_leaves(state["caches"]):
        c.normal_(generator=g)
    before = [c.clone() for c in tree_leaves(state["caches"])]
    state["lengths"] = torch.tensor([2, 5, 1], dtype=torch.int32)
    TM.decode_step(tcfg, tp, state,
                   {"tokens": torch.ones(3, 1, dtype=torch.long)},
                   rows=torch.tensor([1]))
    for (key, name, new), old in zip(_leaves(state["caches"]), before):
        assert torch.equal(old[:, [0, 2]], new[:, [0, 2]]), (key, name)
        if name in ("k", "v"):
            assert torch.equal(old[:, 1, :5], new[:, 1, :5])
            assert not torch.equal(old[:, 1, 5], new[:, 1, 5])
        else:
            assert not torch.equal(old[:, 1], new[:, 1]), (key, name)


def test_rwkv6_bf16_forward_matches_jax():
    """rwkv6 smoke in its own compute dtype (bf16), f32 parameters cast at
    use on both sides: the whole model at BF16_TOL (it has no attention,
    so the packages round at the same points)."""
    jcfg, tcfg, jp, tp = _pair("rwkv6-7b", "bfloat16")
    jb, tb = _batch(jcfg, 5)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    got, _ = TM.forward(tcfg, tp, tb, mode="train")
    assert _rel_max(got, want) < BF16_TOL
    jw, jstate = JM.forward(jcfg, jp, jb, mode="prefill", remat=False)
    tw, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert state["caches"]["pos0"]["x_tm"].dtype == torch.bfloat16
    assert state["caches"]["pos0"]["wkv"].dtype == torch.float32
    assert _rel_max(tw, jw) < BF16_TOL


def test_zamba2_bf16_forward_as_close_to_f32_as_reference():
    """zamba2 smoke in bf16 over its 14 blocks: bf16 rounding flips
    compound, and the reference's own bf16 logits lie ~4e-2 (rel. to the
    largest) from its f32 logits, above BF16_TOL, so the two bf16 runs
    are held to the f32 model instead: the port no further from it than
    the reference, within a quarter of the reference's distance plus one
    bf16 ulp (2^-8). Each block is held at BF16_TOL in
    tests/test_torch_scan.py."""
    jcfg, tcfg, jp, tp = _pair("zamba2-2.7b", "bfloat16")
    jb, tb = _batch(jcfg, 5)
    want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    got, _ = TM.forward(tcfg, tp, tb, mode="train")
    f32, _ = JM.forward(jcfg.replace(dtype="float32"), jp, jb, mode="train",
                        remat=False)
    ref_err = _rel_max(torch.tensor(np.asarray(want, np.float32)), f32)
    port_err = _rel_max(got, f32)
    assert port_err <= 1.25 * ref_err + 2.0 ** -8, (port_err, ref_err)
    assert _rel_max(got, want) <= 2 * ref_err


# ---------------------------------------------------------------- MoE

def _moe_aux_close(got, want):
    assert set(got) == set(want) == {"moe_lb_loss", "moe_z_loss"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_tree_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    assert [l.shape for l in jax.tree_util.tree_leaves(jp)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    assert TM.param_count(tcfg) == JM.param_count(jcfg)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    moe = tp["blocks"][f"pos{len(tcfg.pattern) - 1}"]["moe"]
    assert moe["w_gate"].shape == (tcfg.num_periods, tcfg.num_experts,
                                   tcfg.d_model, tcfg.d_ff)
    assert ("shared" in moe) == bool(tcfg.n_shared_experts)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_train_matches_jax(arch):
    """Logits and the router aux losses (each period's sum, averaged over
    periods), one flash_attention launch per attention block, dense or
    MoE; every layer's expert choices equal."""
    from test_torch_moe import assert_routes_agree, jax_routes, port_routes
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 1)
    with jax_routes() as jr:
        want, jaux = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    before = fa_ops.invocation_count()
    with port_routes() as tr:
        got, aux = TM.forward(tcfg, tp, tb, mode="train")
    assert_routes_agree(tr, jr)
    assert fa_ops.invocation_count() == before + tcfg.num_layers
    assert got.dtype == torch.float32 and got.shape == (B, S, tcfg.vocab_size)
    assert _rel_max(got, want) < F32_TOL
    _moe_aux_close(aux, jaux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_jax(arch):
    """Last logits, every layer's k / v caches (the MoE blocks' too), the
    lengths, and the hidden states with their aux."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 2)
    want, jstate = JM.forward(jcfg, jp, jb, mode="prefill", remat=False)
    got, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == [S] * B
    specs = TM.decode_state_specs(tcfg, B, S)["caches"]
    assert sorted(state["caches"]) == sorted(specs) == sorted(
        jstate["caches"])
    for key, leaves in state["caches"].items():
        for name, tc in leaves.items():
            jc = np.asarray(jstate["caches"][key][name])
            assert tuple(tc.shape) == jc.shape == specs[key][name].shape
            assert _rel_max(tc, jc) < F32_TOL, (key, name)
    hidden, aux = TM.forward(tcfg, tp, tb, mode="hidden")
    jh, jaux = JM.forward(jcfg, jp, jb, mode="hidden", remat=False)
    assert _rel_max(hidden, jh) < F32_TOL
    _moe_aux_close(aux, jaux)


@pytest.mark.parametrize("path,groups", [("dispatch", 0), ("dispatch", 4),
                                         ("dense", 0)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_paths_and_groups_match_jax(arch, path, groups):
    """``moe_path`` and ``moe_groups`` reach every MoE block: the train
    logits and aux of the reference at the same options."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg, 8)
    want, jaux = JM.forward(jcfg, jp, jb, mode="train", remat=False,
                            moe_path=path, moe_groups=groups)
    got, aux = TM.forward(tcfg, tp, tb, mode="train", moe_path=path,
                          moe_groups=groups)
    assert _rel_max(got, want) < F32_TOL
    _moe_aux_close(aux, jaux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_jax(arch):
    """Three decode steps from a zeroed state: logits at every step, then
    the caches and lengths (each row its own routing group)."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jstate = JM.init_decode_state(jcfg, B, 8)
    state = TM.init_decode_state(tcfg, B, 8, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jstate = JM.decode_step(jcfg, jp, jstate,
                                      {"tokens": jnp.asarray(tok)})
        got, state = TM.decode_step(tcfg, tp, state,
                                    {"tokens": torch.tensor(tok)})
        assert _rel_max(got, want) < F32_TOL
    assert state["lengths"].tolist() == np.asarray(jstate["lengths"]).tolist()
    for key, leaves in state["caches"].items():
        for name, tc in leaves.items():
            assert _rel_max(tc, jstate["caches"][key][name]) < F32_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_decode_consistency(arch):
    """decode(prefill(x[:-1]), x[-1]) == forward(x)[-1] inside the port, at
    the JAX package's own bound (tests/test_arch_smoke.py)."""
    _, tcfg, _, tp = _pair(arch)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = TM.forward(tcfg, tp, {"tokens": toks}, mode="train")
    _, state = TM.forward(tcfg, tp, {"tokens": toks[:, :S - 1]},
                          mode="prefill")
    got, _ = TM.decode_step(tcfg, tp, _grow(state, 1),
                            {"tokens": toks[:, S - 1:]})
    rel = float((got - full[:, -1]).abs().max()
                / (full[:, -1].abs().max() + 1e-9))
    assert rel < 2e-3, f"{arch}: prefill+decode rel err {rel}"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_forward_as_close_to_f32_as_reference(arch):
    """The MoE smoke configs in their own compute dtype (bf16), f32
    parameters cast at use on both sides. The packages round attention's
    probabilities at other places (one bf16 ulp), and where two experts'
    gates nearly tie that is enough to route a token elsewhere, which
    moves its output far past rounding (the reference's own bf16 and f32
    runs route apart in the same way). So: (1) any expert choice where
    the free runs differ sits at a gate margin within BF16_TOL; (2) the
    port routed as the reference routed is held as zamba2's bf16 forward
    is, to the reference's f32 model: no further from it than the
    reference's bf16 run, within a quarter of that distance plus one bf16
    ulp (2^-8), and within twice that distance of the reference's bf16
    logits. The block alone is held at BF16_TOL in
    tests/test_torch_moe.py."""
    from test_torch_moe import jax_routes, port_routes, route_flips
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16")
    jb, tb = _batch(jcfg, 5)
    with jax_routes() as jr:
        want, _ = JM.forward(jcfg, jp, jb, mode="train", remat=False)
    with port_routes() as free:
        TM.forward(tcfg, tp, tb, mode="train")
    margins, _ = route_flips(free, jr)
    assert (margins <= BF16_TOL).all(), margins
    with port_routes(pinned=jr):
        got, _ = TM.forward(tcfg, tp, tb, mode="train")
    f32, _ = JM.forward(jcfg.replace(dtype="float32"), jp, jb, mode="train",
                        remat=False)
    ref_err = _rel_max(torch.tensor(np.asarray(want, np.float32)), f32)
    port_err = _rel_max(got, f32)
    assert port_err <= 1.25 * ref_err + 2.0 ** -8, (port_err, ref_err)
    assert _rel_max(got, want) <= 2 * ref_err
    _, state = TM.forward(tcfg, tp, tb, mode="prefill")
    assert state["caches"]["pos0"]["k"].dtype == torch.bfloat16
