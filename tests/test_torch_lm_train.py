"""The port's LM training path against the JAX package's on the CPU:
``train_loss`` and its gradients (six pure-attention smoke configs,
zamba2 / rwkv6 smoke and the two MoE smoke configs with their router
aux losses, loss chunks 1 and 4, remat on), ``apply_update`` on
seeded trees, three ``make_train_step`` steps with and without
microbatching, and the synthetic token streams and batches. Parameters
come from the JAX package's ``init_params`` and cross as numpy through
``params_from_numpy``; batches from both packages' ``synthetic_batch_for``
on the same seed (asserted equal). The JAX side runs its own CPU path
(``attention_xla`` under ``jax.grad``); f32 where the point is the
algorithm."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import model as JM
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as JD
from repro.train import optim as JO
from repro.train import step as JS
from repro_torch.arch import model as TM
from repro_torch.arch.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import synthetic as TD
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

torch.set_num_threads(1)

MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
ARCHS = ["qwen3-1.7b", "llama3-8b", "starcoder2-7b", "internlm2-20b",
         "qwen2-vl-7b", "hubert-xlarge", "zamba2-2.7b", "rwkv6-7b"] \
    + MOE_ARCHS
# The loss: the same f32 sums in other orders (measured <= 1e-7
# relative), held to 1e-5.
LOSS_RTOL = 1e-5
# A gradient leaf against the reference's, max |diff| over the leaf's max
# |ref|: measured <= 1.5e-6 for the attention families, 1.5e-5 for zamba2
# (the port's plain SSD scan computes in f64, the reference's in f32).
GRAD_TOL = 1e-4
# Parameters after AdamW steps. The update is lr * m_hat / (sqrt(v_hat)
# + eps): for a gradient entry at the noise level of the f32 sums, the two
# packages' last-digit differences change that ratio by up to ~1e-2, so a
# weight can move differently by ~lr * 1e-2 a step (measured 4.8e-6 after
# three steps at lr 3e-4, 2 of 16,384 entries of one leaf past 1e-6).
PARAM_ATOL = 2e-5
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    jcfg = jax_get_config(arch + "-smoke").replace(dtype=dtype)
    tcfg = get_config(arch + "-smoke").replace(dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _tparams(np_params):
    return params_from_numpy(np_params, "cpu")


def _batches(jcfg, tcfg, seed, batch=B, seq=S):
    jb = JD.synthetic_batch_for(jcfg, JShapeSpec("t", seq, batch, "train"),
                                seed=seed)
    tb = TD.synthetic_batch_for(tcfg, ShapeSpec("t", seq, batch, "train"),
                                seed=seed, device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].dtype == getattr(torch, str(jb[k].dtype))
        np.testing.assert_array_equal(np.asarray(jb[k]).astype(np.float32),
                                      tb[k].float().numpy())
    return jb, tb


def _port_value_and_grad(cfg, params, batch, **kw):
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = TM.train_loss(cfg, TS._unflatten(params, live), batch,
                                  **kw)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(live, grads)]


def _grad_close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err <= GRAD_TOL, err


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, chunks):
    jcfg, tcfg, jp, np_p = _pair(arch)
    jb, tb = _batches(jcfg, tcfg, seed=3)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, jb, loss_chunks=chunks),
        has_aux=True)(jp)
    loss, metrics, grads = _port_value_and_grad(tcfg, _tparams(np_p), tb,
                                                loss_chunks=chunks)
    # the loss, the cross-entropy and, with MoE blocks, the aux losses
    assert {"loss", "ce"} <= set(metrics) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        _grad_close(g, w)


def test_loss_chunks_auto_rule_and_remat():
    """Auto chunking (``max(1, min(16, S // 512))``, lowered until it
    divides S) gives the unchunked loss; remat changes no gradient; each
    attention block runs once in the forward and again in the backward's
    recompute, and its backward once."""
    jcfg, tcfg, jp, np_p = _pair("qwen3-1.7b")
    p = _tparams(np_p)
    tb = TD.synthetic_batch_for(tcfg, ShapeSpec("t", 1536, 1, "train"),
                                seed=4, device="cpu")
    auto, _ = TM.train_loss(tcfg, p, tb)               # 3 chunks of 512
    whole, _ = TM.train_loss(tcfg, p, tb, loss_chunks=1)
    np.testing.assert_allclose(float(auto), float(whole), rtol=1e-6)
    jb = _batches(jcfg, tcfg, seed=5)[1]
    fa_ops.reset_invocation_count()
    _, _, g_remat = _port_value_and_grad(tcfg, p, jb, remat=True)
    n_layers = tcfg.num_periods
    assert fa_ops.invocation_count() == 2 * n_layers
    assert fa_ops.backward_invocation_count() == n_layers
    _, _, g_plain = _port_value_and_grad(tcfg, p, jb, remat=False)
    for a, b in zip(g_remat, g_plain):
        assert torch.equal(a, b)


def _seeded_tree(seed, like):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), like)


def test_apply_update_matches_jax():
    """Three AdamW updates from seeded params and gradients (one gradient
    tree large enough to clip), the moments and step count carried."""
    _, _, _, np_p = _pair("qwen3-1.7b")
    opt = JO.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    topt = TO.AdamWConfig(**dataclasses.asdict(opt))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_p)
    tparams = _tparams(np_p)
    jstate, tstate = JO.init_state(jparams, opt), TO.init_state(tparams, topt)
    assert tstate.step.dtype == torch.int32 and tstate._fields == jstate._fields
    for i, scale in enumerate((0.01, 3.0, 0.2)):
        g = jax.tree_util.tree_map(lambda a: a * scale,
                                   _seeded_tree(10 + i, np_p))
        jparams, jstate, jm = JO.apply_update(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate, opt)
        tparams, tstate, tm = TO.apply_update(tparams, _tparams(g), tstate,
                                              topt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for want, got in ((jparams, tparams), (jstate.mu, tstate.mu),
                      (jstate.nu, tstate.nu)):
        for w, t in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)


def test_state_specs_mirror_init_state():
    _, _, _, np_p = _pair("qwen3-1.7b")
    p = _tparams(np_p)
    specs = TO.state_specs(tree_map(lambda t: t, p))
    state = TO.init_state(p)
    assert specs.step == (tuple(state.step.shape), state.step.dtype)
    for s, t in zip(tree_leaves(specs.mu), tree_leaves(state.mu)):
        assert s == (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three steps of ``make_train_step`` (f32 compute, remat on) from the
    same params on the same batches: loss, grad norm and params."""
    jcfg, tcfg, jp, np_p = _pair("qwen3-1.7b")
    jstep = JS.make_train_step(jcfg, microbatches=microbatches)
    tstep = TS.make_train_step(tcfg, microbatches=microbatches)
    jparams, tparams = jp, _tparams(np_p)
    jstate, tstate = JO.init_state(jparams), TO.init_state(tparams)
    for i in range(3):
        jb, tb = _batches(jcfg, tcfg, seed=20 + i, batch=4)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        assert set(tm) == {"loss", "ce", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    for w, t in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)


def test_microbatching_averages_the_gradient():
    """Two microbatches of 2 rows give the one-batch step's params (the
    mean of the halves' mean losses is the whole batch's mean)."""
    _, tcfg, _, np_p = _pair("qwen3-1.7b")
    tb = TD.synthetic_lm_batch(tcfg.vocab_size, 4, S, seed=7, device="cpu")
    p = _tparams(np_p)
    outs = [TS.make_train_step(tcfg, microbatches=m)(p, TO.init_state(p), tb)
            for m in (1, 2)]
    np.testing.assert_allclose(float(outs[1][2]["loss"]),
                               float(outs[0][2]["loss"]), rtol=1e-6)
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)


def test_grad_hook_and_bf16_cast():
    """``grad_hook`` sees the gradient tree before the update (zeroing it
    leaves only weight decay); ``cast_params_bf16`` keeps f32 masters and
    a loss within bf16 rounding of the f32 one."""
    _, tcfg, _, np_p = _pair("qwen3-1.7b")
    p = _tparams(np_p)
    tb = TD.synthetic_lm_batch(tcfg.vocab_size, 2, S, seed=8, device="cpu")
    seen = []

    def hook(g):
        seen.append(g)
        return tree_map(torch.zeros_like, g)

    opt = TO.AdamWConfig()
    new, state, m = TS.make_train_step(tcfg, grad_hook=hook)(
        p, TO.init_state(p), tb)
    assert sorted(seen[0]) == sorted(p) and float(m["grad_norm"]) == 0.0
    for a, b in zip(tree_leaves(new), tree_leaves(p)):
        torch.testing.assert_close(a, b - opt.lr * opt.weight_decay * b)
    new, _, mb = TS.make_train_step(tcfg, cast_params_bf16=True)(
        p, TO.init_state(p), tb)
    _, _, mf = TS.make_train_step(tcfg)(p, TO.init_state(p), tb)
    assert all(t.dtype == torch.float32 for t in tree_leaves(new))
    np.testing.assert_allclose(float(mb["loss"]), float(mf["loss"]),
                               rtol=2e-2)


@pytest.mark.parametrize("moe", [{}, {"moe_path": "dense"},
                                 {"moe_groups": 4}])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_steps_match_jax(arch, moe):
    """Two ``make_train_step`` steps of an MoE smoke config (f32, remat
    on) from the same params on the same batches, at the default routing,
    the dense path and 4 token groups: the loss, the router aux losses in
    the metrics, the grad norm, then the params."""
    jcfg, tcfg, jp, np_p = _pair(arch)
    jstep = JS.make_train_step(jcfg, **moe)
    tstep = TS.make_train_step(tcfg, **moe)
    jparams, tparams = jp, _tparams(np_p)
    jstate, tstate = JO.init_state(jparams), TO.init_state(tparams)
    for i in range(2):
        jb, tb = _batches(jcfg, tcfg, seed=40 + i, batch=4)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        assert set(tm) == set(jm) == {"loss", "ce", "moe_lb_loss",
                                      "moe_z_loss", "grad_norm"}
        for key in ("loss", "ce", "moe_lb_loss", "moe_z_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    for w, t in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("moe", [{"moe_path": "dense"}, {"moe_groups": 4}])
def test_moe_options_reach_prefill_and_decode(moe):
    """``make_prefill_step`` and ``make_decode_step`` pass ``moe_path`` and
    ``moe_groups`` to the model: the reference's logits at the same
    options."""
    jcfg, tcfg, jp, np_p = _pair("dbrx-132b")
    p = _tparams(np_p)
    tok = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = JS.make_prefill_step(jcfg, **moe)(jp, {"tokens": jnp.asarray(tok)})
    got, _ = TS.make_prefill_step(tcfg, **moe)(p, {"tokens": torch.tensor(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    nxt = tok[:, :1]
    want, _ = JS.make_decode_step(jcfg, **moe)(
        jp, JM.init_decode_state(jcfg, B, 8), {"tokens": jnp.asarray(nxt)})
    got, _ = TS.make_decode_step(tcfg, **moe)(
        p, TM.init_decode_state(tcfg, B, 8, device="cpu"),
        {"tokens": torch.tensor(nxt)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))


def test_prefill_and_decode_steps_match_forward():
    _, tcfg, _, np_p = _pair("qwen3-1.7b")
    p = _tparams(np_p)
    tb = {"tokens": TD.synthetic_lm_batch(tcfg.vocab_size, B, S, seed=9,
                                          device="cpu")["tokens"]}
    logits, state = TS.make_prefill_step(tcfg)(p, tb)
    want, _ = TM.forward(tcfg, p, tb, mode="prefill")
    assert torch.equal(logits, want)
    nxt = {"tokens": torch.argmax(logits, -1, keepdim=True).to(torch.int32)}
    fresh = [TM.init_decode_state(tcfg, B, 8, device="cpu") for _ in "ab"]
    out, state = TS.make_decode_step(tcfg)(p, fresh[0], nxt)
    want, _ = TM.decode_step(tcfg, p, fresh[1], nxt)
    assert torch.equal(out, want) and int(state["lengths"][0]) == 1


@pytest.mark.parametrize("host_count", [1, 2])
def test_token_streams_identical(host_count):
    kw = dict(host_count=host_count, host_index=host_count - 1, seed=3)
    js = JD.SyntheticTokenStream(1000, 8, 32, **kw)
    ts = TD.SyntheticTokenStream(1000, 8, 32, device="cpu", **kw)
    for _ in range(4):
        jb, tb = js.next(), ts.next()
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert ts.step == js.step == 4
    with pytest.raises(ValueError, match="does not split"):
        TD.SyntheticTokenStream(10, 3, 4, host_count=2, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for kind in ("train", "prefill", "decode"):
        if kind == "decode" and tcfg.frontend == "frames":
            with pytest.raises(ValueError, match="encoder-only"):
                TD.input_specs_for(tcfg, ShapeSpec("d", 64, 2, kind))
            continue
        js = JD.input_specs_for(jcfg, JShapeSpec("x", 64, 2, kind))
        ts = TD.input_specs_for(tcfg, ShapeSpec("x", 64, 2, kind))
        assert list(js) == list(ts)
        for k in js:
            assert ts[k].shape == js[k].shape
            assert str(ts[k].dtype)[6:] == str(js[k].dtype)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_rehearsal_on_cpu():
    """chip_smoke.py's backward kernel phase, training parity, training
    path, launcher and guard phases at a tiny size through the plain
    versions: the same checks the card run makes."""
    smoke = _chip_smoke()
    cases = [("train", 1, 64, 64, 4, 2, 16, "bfloat16", True)] + [
        c for c in smoke.FLASH_BWD_CASES[1:] if c[1] * c[2] <= 128]
    rec = smoke.flash_backward_phase("cpu", cases, time_it=False)
    assert rec["max_abs_err"] == 0.0 and rec["bound_by"] == "bytes"
    err = smoke.lm_train_parity("cpu", "qwen3-1.7b-smoke", seq=32)
    assert set(err) == set(smoke.LM_PARITY_TOL)
    assert max(err[k] for k in ("loss", "grad_norm", "grad")) == 0
    assert err["update_excess"] <= 0
    train = smoke.lm_train_path("cpu", "qwen3-1.7b-smoke", batch=2, seq=32,
                                steps=4, profile=False)
    cfg = get_config("qwen3-1.7b-smoke")
    assert train["launches"]["flash_attention"] == 4 * 2 * cfg.num_layers
    assert train["launches"]["flash_attention_backward"] == 4 * cfg.num_layers
    assert train["peak_bytes"] is None
    out = smoke.launcher_phase("cpu", steps=6, every=2, fail_at=3)
    assert len(out["losses"]) == 7
    smoke.guard_phase("cpu")


@pytest.mark.parametrize("arch,layers", [("zamba2-2.7b-smoke", 6),
                                         ("rwkv6-7b-smoke", 2)])
def test_chip_smoke_recurrent_train_rehearsal_on_cpu(arch, layers):
    """chip_smoke.py's recurrent training phases at a tiny size through
    the plain versions: the parity (one zamba2 period, two rwkv6 layers),
    the path cut to whole periods with its launches per step (each scan
    forward twice, its backward once; zamba2's shared block's attention
    likewise), and the rounding-gap model behind the parity tolerance."""
    smoke = _chip_smoke()
    full = smoke.RECURRENT_PARITY_TOL[arch.removesuffix("-smoke")]
    err = smoke.lm_train_parity("cpu", arch, layers=layers, seq=32, tol=full)
    assert max(err[k] for k in ("loss", "grad_norm", "grad")) == 0
    cfg = get_config(arch)
    cut = cfg.period_len * (cfg.num_periods - 1) if cfg.num_periods > 1 \
        else cfg.num_layers
    train = smoke.lm_train_path("cpu", arch, batch=2, seq=32, steps=3,
                                layers=cut, profile=False)
    periods = cut // cfg.period_len
    want = {n: 0 for n in smoke.COUNT_NAMES}
    for kind, name in (("mamba2", "ssd_scan"), ("rwkv6", "wkv6_scan")):
        per = periods * cfg.pattern.count(kind)
        want[name], want[f"{name}_backward"] = 3 * 2 * per, 3 * per
    if cfg.shared_attn_every_period:
        want["flash_attention"] = 3 * 2 * periods
        want["flash_attention_backward"] = 3 * periods
    assert train["launches"] == want
    gaps = smoke.parity_rounding_gaps(arch, layers=layers, seq=32)
    assert set(gaps) == {"scans", "threads"}
    for gap in gaps.values():
        assert set(gap) == {"loss", "grad_norm", "grad", "worst_leaf"}
        assert gap["grad"] < full["grad"] and gap["loss"] < full["loss"]


def test_chip_smoke_update_excess_accounts_for_the_clip_scale():
    """Two sides whose global norms differ by 6e-6 (a few large gradients
    apart) both clip: elements near |g| = eps / s, equal on both sides,
    move apart through the clip scale alone. The parity's bound allows
    that and nothing more; without its clip term they exceed it."""
    from repro_torch.train.optim import AdamWConfig, apply_update, init_state
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(100000, generator=gen)}
    g = torch.rand(100000, generator=gen) * 2e-6
    g[:10] = 30.0
    other = g.clone()
    other[:10] *= 1 + 6e-6
    opt = AdamWConfig()
    (pa, _, ma), (pb, _, mb) = (apply_update(p, {"w": x}, init_state(p), opt)
                                for x in (g, other))
    norms = (ma["grad_norm"], mb["grad_norm"])
    args = (pa, pb, {"w": g}, {"w": other}, p, opt)
    assert smoke._update_excess(*args, norms) <= 0
    assert smoke._update_excess(*args, norms[:1] * 2) > 0


def test_chip_smoke_backward_bound():
    """The backward's bound: five products of the visible pairs (2.5x the
    forward's operations), each of q, k, v, the output, its gradient and
    lse read once and dq, dk, dv written once; at the qwen3-1.7b training
    shape 0.0435 ms of bf16 tensor-core time."""
    smoke = _chip_smoke()
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    k = torch.zeros(1, 6, 1, 8, dtype=torch.bfloat16)
    b = smoke.flash_backward_bound(q, k, True)
    assert b["flops"] == 5 * smoke.flash_bound(q, k, True)["flops"] // 2
    assert b["bytes"] == 4 * (64 + 48) * 2 + 2 * 4 * 4
    q = torch.zeros(4, 1024, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(4, 1024, 8, 128, dtype=torch.bfloat16)
    b = smoke.flash_backward_bound(q, k, True)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - 0.0435) < 1e-4
