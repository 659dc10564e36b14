"""The port's MoE block (``repro_torch.arch.moe``) against the JAX
package's (``repro.arch.moe``) on the CPU: the router (weights, expert
indices, the load-balance and z aux losses), the dense path and the
capacity-bounded dispatch at ample, default and tight capacity over
groups 0, 1 and 4, with and without the shared expert, f32 and bf16;
the dropped choices; gradients against ``jax.grad``; the reference's own
properties (tests/test_moe.py) run on the port; parameter accounting of
all ten published configs; and the sliced parameter draw.

Parameters come from the JAX package's ``init_tree`` and cross as numpy
through ``params_from_numpy``; inputs from numpy with a seed. Routing is
discontinuous, so wherever two runs' expert choices are compared, a
mismatch is reported as the number of (token, layer, choice) entries that
differ and the smallest gate margin among them (``assert_routes_agree``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import model as JM
from repro.arch import moe as JMoe
from repro.arch.params import init_tree as jax_init_tree
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro_torch.arch import model as TM
from repro_torch.arch import moe as TMoe
from repro_torch.arch import params as TP
from repro_torch.arch.params import params_from_numpy, tree_leaves
from repro_torch.configs import get_config

torch.set_num_threads(1)

MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
# the same f32 arithmetic in other orders: a few ulps of the largest
# element (tests/test_torch_lm.py's F32_TOL); bf16 at its BF16_TOL
F32_TOL = 2e-5
BF16_TOL = 2e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
CAPACITY_FACTORS = [8.0, 1.25, 0.25]
GROUPS = [0, 1, 4]


def _cfgs(arch="dbrx-132b", shared=None, dtype="float32", d=32, ff=64,
          E=4, k=2):
    """The JAX and port configs of a small MoE block (the JAX package's
    tests/test_moe.py sizes), the shared expert on or off."""
    kw = dict(d_model=d, d_ff=ff, num_experts=E, num_experts_per_tok=k,
              dtype=dtype)
    if shared is not None:
        kw["n_shared_experts"] = shared
    return (jax_get_config(arch + "-smoke").replace(**kw),
            get_config(arch + "-smoke").replace(**kw))


def _block(jcfg, seed=0, B=2, S=16):
    """(JAX params, port params, JAX x, port x): f32 params from the JAX
    init, x from numpy in the config's dtype on both sides."""
    jp = jax_init_tree(JMoe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    return (jp, tp, jnp.asarray(x).astype(jcfg.dtype),
            torch.tensor(x).to(getattr(torch, jcfg.dtype)))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel_max(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ------------------------------------------------------------ routes

@contextlib.contextmanager
def jax_routes():
    """Every call of the JAX package's ``moe._router`` while the block
    runs (inside ``lax.scan`` too, through ``jax.debug.callback``): its
    expert indices and router logits as numpy."""
    calls = []
    own = JMoe._router

    def router(cfg, p, x):
        w, idx, aux = own(cfg, p, x)
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        jax.debug.callback(
            lambda i, lg: calls.append({"idx": np.asarray(i),
                                        "logits": np.asarray(lg)}),
            idx, logits, ordered=True)
        return w, idx, aux

    JMoe._router = router
    try:
        yield calls
    finally:
        JMoe._router = own


@contextlib.contextmanager
def port_routes(pinned=None):
    """Every call of the port's ``moe._router`` while the block runs. With
    ``pinned`` (recorded calls, one per call in order, of another run)
    each call routes to those experts instead, weighted by its own gates
    renormalised over them, as ``_router`` weights its own choices."""
    calls = []
    own = TMoe._router

    def router(cfg, p, x):
        w, idx, aux = own(cfg, p, x)
        logits = x.float() @ p["router"].float()
        if pinned is not None:
            idx = torch.tensor(pinned[len(calls)]["idx"], dtype=torch.long)
            w = torch.gather(torch.softmax(logits, -1), -1, idx)
            w = w / w.sum(-1, keepdim=True)
        calls.append({"idx": idx.detach().numpy(),
                      "logits": logits.detach().numpy()})
        return w, idx, aux

    TMoe._router = router
    try:
        yield calls
    finally:
        TMoe._router = own


def route_flips(got, want):
    """The gate margins of the (token, layer, choice) entries where two
    runs' recorded routes differ (|gate of ``want``'s expert - gate of
    ``got``'s|, on ``want``'s gates), and the number of entries."""
    assert len(got) == len(want) > 0, (len(got), len(want))
    gi, wi, lg = (np.concatenate([c[key].reshape(-1, c[key].shape[-1])
                                  for c in calls])
                  for key, calls in (("idx", got), ("idx", want),
                                     ("logits", want)))
    gates = np.exp(lg - lg.max(-1, keepdims=True), dtype=np.float64)
    gates /= gates.sum(-1, keepdims=True)
    margin = np.abs(np.take_along_axis(gates, wi, -1)
                    - np.take_along_axis(gates, gi, -1))
    return margin[gi != wi], gi.size


def assert_routes_agree(got, want):
    """Both runs' expert choices equal, call by call; otherwise fail with
    how many (token, layer, choice) entries differ and the smallest gate
    margin among them, not a bare logit mismatch."""
    margins, n = route_flips(got, want)
    if margins.size:
        raise AssertionError(
            f"{margins.size} of {n} (token, layer, choice) entries differ; "
            f"smallest gate margin among them {margins.min():.3e}")


def _fifo_slots(ig):
    """Each choice's slot by a plain loop: first come first served by
    (token, choice) within each (group, expert)."""
    G, Sg, k = ig.shape
    out = np.zeros(ig.shape, np.int64)
    for g in range(G):
        seen = {}
        for s in range(Sg):
            for j in range(k):
                e = int(ig[g, s, j])
                out[g, s, j] = seen.get(e, 0)
                seen[e] = out[g, s, j] + 1
    return out


def _jax_kept(jcfg, idx, B, S, cf, groups):
    """The reference's kept choices, from its own slot rule
    (``repro.arch.moe.moe_block_dispatch``: an exclusive cumsum over the
    one-hot choices of each group) applied to its own indices."""
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    G, Sg, C = TMoe.dispatch_geometry(jcfg, B * S, cf, groups)
    mask = jax.nn.one_hot(jnp.asarray(idx).reshape(G, Sg, k), E,
                          dtype=jnp.int32)
    flat = mask.reshape(G, Sg * k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    slot = jnp.sum(pos.reshape(G, Sg, k, E) * mask, axis=-1)
    return np.asarray(slot < C)


# ------------------------------------------------------------ the block

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp, jx, tx = _block(jcfg)
    jw, jidx, jaux = JMoe._router(jcfg, jp, jx)
    tw, tidx, taux = TMoe._router(tcfg, tp, tx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tw.dtype == torch.float32
    assert _rel_max(tw, jw) < F32_TOL
    assert set(taux) == set(jaux) == {"moe_lb_loss", "moe_z_loss"}
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
def test_dense_matches_jax(shared, dtype):
    jcfg, tcfg = _cfgs(shared=shared, dtype=dtype)
    jp, tp, jx, tx = _block(jcfg, seed=2)
    want, jaux = JMoe.moe_block_dense(jcfg, jp, jx)
    got, taux = TMoe.moe_block_dense(tcfg, tp, tx)
    assert got.dtype == tx.dtype
    assert _rel_max(got, want) < TOL[dtype]
    np.testing.assert_allclose(float(taux["moe_lb_loss"]),
                               float(jaux["moe_lb_loss"]), rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("shared", [0, 1])
def test_dispatch_matches_jax(shared, cf, groups, dtype):
    """Outputs, expert indices and the kept choices: the port's slots
    equal a plain first-come-first-served loop, its kept set the
    reference's; at tight capacity in one group of 32 tokens (C 4 for 64
    choices over 4 experts) some choices drop, at ample none."""
    jcfg, tcfg = _cfgs(shared=shared, dtype=dtype)
    B, S = 2, 16
    jp, tp, jx, tx = _block(jcfg, seed=3, B=B, S=S)
    want, _ = JMoe.moe_block_dispatch(jcfg, jp, jx, capacity_factor=cf,
                                      groups=groups)
    got, _ = TMoe.moe_block_dispatch(tcfg, tp, tx, capacity_factor=cf,
                                     groups=groups)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel_max(got, want) < TOL[dtype]

    _, jidx, _ = JMoe._router(jcfg, jp, jx)
    _, tidx, _ = TMoe._router(tcfg, tp, tx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    G, Sg, C = TMoe.dispatch_geometry(tcfg, B * S, cf, groups)
    ig = tidx.reshape(G, Sg, -1)
    slots = TMoe.dispatch_slots(ig, tcfg.num_experts).numpy()
    np.testing.assert_array_equal(slots, _fifo_slots(ig.numpy()))
    kept = slots < C
    np.testing.assert_array_equal(
        kept, _jax_kept(jcfg, jidx, B, S, cf, groups))
    if cf == 0.25 and groups == 1:
        assert not kept.all()
    if cf == 8.0:
        assert kept.all()


@pytest.mark.parametrize("tokens,cf,groups,want", [
    (32, 1.25, 0, (32, 1, 2)),       # groups min(T, 256): one token each
    (32, 1.25, 1, (1, 32, 20)),      # ceil4(int(1.25 * 32 * 2 / 4)) = 20
    (32, 0.25, 4, (4, 8, 4)),        # at least 4
    (30, 8.0, 4, (3, 10, 20)),       # 4 lowered to 3 to divide 30; Sg * k
    (4096, 1.25, 0, (256, 16, 12)),  # ceil4(int(10))
])
def test_dispatch_geometry(tokens, cf, groups, want):
    _, tcfg = _cfgs()
    assert TMoe.dispatch_geometry(tcfg, tokens, cf, groups) == want


def test_block_paths_match_jax():
    """``moe_block``: dense, and dispatch at the default capacity with
    groups, against the reference's."""
    jcfg, tcfg = _cfgs(shared=1)
    jp, tp, jx, tx = _block(jcfg, seed=4)
    for path, groups in (("dense", 0), ("dispatch", 0), ("dispatch", 2)):
        want, _ = JMoe.moe_block(jcfg, jp, jx, path=path, groups=groups)
        got, _ = TMoe.moe_block(tcfg, tp, tx, path=path, groups=groups)
        assert _rel_max(got, want) < F32_TOL, (path, groups)


# ------------------------------------------------ the reference's properties

def test_dispatch_matches_dense_with_ample_capacity():
    jcfg, tcfg = _cfgs()
    _, tp, _, tx = _block(jcfg)
    y_dense, aux_d = TMoe.moe_block_dense(tcfg, tp, tx)
    y_disp, aux_s = TMoe.moe_block_dispatch(tcfg, tp, tx,
                                            capacity_factor=8.0, groups=4)
    np.testing.assert_allclose(y_dense.numpy(), y_disp.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux_d["moe_lb_loss"]),
                               float(aux_s["moe_lb_loss"]), rtol=1e-6)


def test_dispatch_drops_over_capacity():
    jcfg, tcfg = _cfgs()
    _, tp, _, tx = _block(jcfg, B=1, S=32)
    tight, _ = TMoe.moe_block_dispatch(tcfg, tp, tx, capacity_factor=0.25,
                                       groups=1)
    ample, _ = TMoe.moe_block_dispatch(tcfg, tp, tx, capacity_factor=8.0,
                                       groups=1)
    assert not np.allclose(tight.numpy(), ample.numpy())
    # a token whose every choice dropped contributes exactly zero
    norms = np.linalg.norm(tight.numpy(), axis=-1)
    assert (norms < 1e-6).any()


def test_router_weights_normalised():
    jcfg, tcfg = _cfgs()
    _, tp, _, tx = _block(jcfg)
    w, idx, aux = TMoe._router(tcfg, tp, tx)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    assert int(idx.max()) < tcfg.num_experts
    assert float(aux["moe_lb_loss"]) >= 1.0 - 1e-3


def test_shared_expert_always_on():
    jcfg, tcfg = _cfgs(shared=1)
    _, tp, _, tx = _block(jcfg, seed=3)
    y, _ = TMoe.moe_block_dispatch(tcfg, tp, tx, capacity_factor=0.01,
                                   groups=1)
    assert float(y.abs().max()) > 0


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("path,cf", [("dispatch", 1.25), ("dispatch", 0.25),
                                     ("dense", None)])
@pytest.mark.parametrize("shared", [0, 1])
def test_block_gradients_match_jax(shared, path, cf):
    """d(sum(y * c) + aux) with respect to every parameter and x: through
    the renormalised top-k gates and the combine weights (the one-hot
    masks carry none)."""
    jcfg, tcfg = _cfgs(shared=shared)
    jp, tp, jx, tx = _block(jcfg, seed=5)
    cot = np.random.default_rng(6).normal(size=tx.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = (JMoe.moe_block_dense(jcfg, p, x) if path == "dense" else
                  JMoe.moe_block_dispatch(jcfg, p, x, capacity_factor=cf,
                                          groups=2))
        return (jnp.sum(y * cot) + aux["moe_lb_loss"]
                + aux["moe_z_loss"])

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    xt = tx.clone().requires_grad_(True)
    from repro_torch.train.step import _unflatten
    p = _unflatten(tp, leaves)
    y, aux = (TMoe.moe_block_dense(tcfg, p, xt) if path == "dense" else
              TMoe.moe_block_dispatch(tcfg, p, xt, capacity_factor=cf,
                                      groups=2))
    loss = torch.sum(y * torch.tensor(cot)) + aux["moe_lb_loss"] \
        + aux["moe_z_loss"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    want = jax.tree_util.tree_leaves(jg_p) + [jg_x]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert _rel_max(g, w) < F32_TOL


# ------------------------------------------------------------ models

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_routes_agree_with_jax(arch):
    """Every layer's expert choices of a whole smoke model's forward
    (train and prefill modes) and three decode steps, port against the
    JAX package."""
    jcfg = jax_get_config(arch + "-smoke").replace(dtype="float32")
    tcfg = get_config(arch + "-smoke").replace(dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    for mode in ("train", "prefill"):
        with jax_routes() as want:
            JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)}, mode=mode,
                       remat=False)
        with port_routes() as got:
            TM.forward(tcfg, tp, {"tokens": torch.tensor(tok)}, mode=mode)
        n_moe = jcfg.num_periods * jcfg.pattern.count("attn_moe")
        assert len(got) == n_moe
        assert_routes_agree(got, want)
    jstate = JM.init_decode_state(jcfg, 2, 4)
    state = TM.init_decode_state(tcfg, 2, 4, device="cpu")
    with jax_routes() as want, port_routes() as got:
        for i in range(3):
            _, jstate = JM.decode_step(jcfg, jp, jstate,
                                       {"tokens": jnp.asarray(tok[:, i:i + 1])})
            _, state = TM.decode_step(tcfg, tp, state,
                                      {"tokens": torch.tensor(tok[:, i:i + 1])})
    assert_routes_agree(got, want)


def test_assert_routes_agree_reports_count_and_margin():
    want = [{"idx": np.array([[0, 1], [2, 3]]),
             "logits": np.array([[2.0, 1.0, 0.0, -1.0],
                                 [0.0, 0.0, 1.0, 1.0]])}]
    got = [{"idx": np.array([[0, 1], [3, 2]]), "logits": want[0]["logits"]}]
    with pytest.raises(AssertionError, match=r"2 of 4 .* 0\.000e\+00"):
        assert_routes_agree(got, want)
    assert_routes_agree(want, want)


@pytest.mark.parametrize("arch", jax_list_archs())
def test_accounting_matches_jax(arch):
    """``param_count``, ``active_param_count`` and the shapes of
    ``param_shape_structs`` for every full published config, without
    drawing any of it."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert TM.param_count(tcfg) == JM.param_count(jcfg)
    assert TM.active_param_count(tcfg) == JM.active_param_count(jcfg)
    want = jax.tree_util.tree_leaves(JM.param_shape_structs(jcfg))
    got = tree_leaves(TM.param_shape_structs(tcfg, torch.bfloat16))
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in got)


def test_moe_full_width_sizes():
    """dbrx-132b and llama4-maverick at the card's cuts: 8 of dbrx's 40
    layers, one of maverick's 24 periods."""
    dbrx = get_config("dbrx-132b").replace(num_layers=8)
    mav = get_config("llama4-maverick-400b-a17b").replace(num_layers=2)
    assert TM.param_count(dbrx) == JM.param_count(
        jax_get_config("dbrx-132b").replace(num_layers=8)) == 27_305_809_920
    assert TM.param_count(mav) == 18_553_267_200
    leaf = TM.param_shape_structs(dbrx)["blocks"]["pos0"]["moe"]["w_gate"]
    assert tuple(leaf.shape) == (8, 16, 6144, 10752)
    spec = TM.decode_state_specs(mav, 4, 512)["caches"]
    assert set(spec) == {"pos0", "pos1"}
    assert spec["pos1"]["k"].shape == (1, 4, 512, 8, 128)


# ------------------------------------------------------------ the draw

def test_sliced_draw_is_deterministic_and_holds_one_slice(monkeypatch):
    """A leaf is drawn in flat slices of ``DRAW_SLICE`` f32 elements into
    its tensor of the target dtype: never more than one slice in f32 at a
    time; the same generator seed gives the same values; the init law's
    mean and std hold."""
    monkeypatch.setattr(TP, "DRAW_SLICE", 1 << 12)
    spec = TP.ParamSpec((3, 64, 96), ("x", "embed", "mlp"))
    sizes = []
    randn = torch.randn

    def recorded(*args, **kw):
        out = randn(*args, **kw)
        sizes.append(out.numel())
        assert out.dtype == torch.float32
        return out

    monkeypatch.setattr(torch, "randn", recorded)
    a = TP.init_tree({"w": spec}, torch.Generator().manual_seed(1),
                     torch.bfloat16)["w"]
    b = TP.init_tree({"w": spec}, torch.Generator().manual_seed(1),
                     torch.bfloat16)["w"]
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == spec.shape
    assert torch.equal(a, b)
    assert max(sizes) == 1 << 12 and sum(sizes) == 2 * a.numel()
    std = 1.0 / np.sqrt(64)
    vals = a.float()
    assert abs(float(vals.mean())) < 0.02 * std * 10
    assert abs(float(vals.std()) / std - 1) < 0.02


@pytest.mark.parametrize("init,lo,hi", [("ssm_A", np.log(1.0), np.log(16.0)),
                                        ("rwkv_decay", -3.0, -0.5)])
def test_sliced_draw_keeps_the_uniform_laws(monkeypatch, init, lo, hi):
    monkeypatch.setattr(TP, "DRAW_SLICE", 100)
    spec = TP.ParamSpec((40, 25), ("a", "b"), init)
    t = TP.init_tree({"w": spec}, torch.Generator().manual_seed(2))["w"]
    assert float(t.min()) >= lo and float(t.max()) <= hi
    assert float(t.max()) - float(t.min()) > 0.9 * (hi - lo)


def test_small_leaves_draw_as_before():
    """A leaf within one slice draws exactly the values of one
    ``torch.randn`` of its shape, scaled, then cast."""
    spec = TP.ParamSpec((8, 16), ("embed", "mlp"))
    got = TP.init_tree({"w": spec}, torch.Generator().manual_seed(3),
                       torch.bfloat16)["w"]
    want = (torch.randn((8, 16), generator=torch.Generator().manual_seed(3))
            * (1.0 / np.sqrt(8))).to(torch.bfloat16)
    assert torch.equal(got, want)
