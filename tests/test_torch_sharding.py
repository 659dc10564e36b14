"""The port's LM sharding rules against the JAX package's, and its DTensor
placements in a gloo world.

``spec_for`` of both packages makes the same decision for every parameter
leaf of the ten configs, every activation the hooks receive, the batch
leaves and every decode-state leaf, under ``baseline_rules``,
``serve_rules`` and ``sp_rules``, on meshes (2, 4) and (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model"). The JAX
rules read only ``mesh.shape`` and ``mesh.axis_names``, so both packages get
a stand-in mesh with no devices (the JAX functions that wrap a spec in a
``NamedSharding`` get one that returns the spec). A recording hook sees the
same (names, shape) calls in the port's ``forward``, ``train_loss`` and
``decode_step`` as in the JAX package's, whose ``lax.scan`` over periods
is run as a Python loop for the test, and ``jax.checkpoint`` as the
function itself (it traces once and replays), so that its body is called
once a period, as the port's loop calls it. Then ``placements`` and
``make_shard_fn`` on DTensors in one gloo world of 4 processes."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.sharding as JS
from _torch_dist_worker import run_world, sharding_world
from repro.arch import model as JM
from repro.arch import params as JParams
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro_torch.arch import model as TM
from repro_torch.arch import params as TParams
from repro_torch.arch.params import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import step as TStep

torch.set_num_threads(1)

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULES = ["baseline_rules", "serve_rules", "sp_rules"]
HOOK_ARCHS = ["qwen3-1.7b-smoke", "dbrx-132b-smoke"]
B, S = 2, 16


def _meshes(i):
    """(JAX stand-in, port stand-in) of ``MESHES[i]``."""
    shape, axes = MESHES[i]
    return (types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                  axis_names=axes),
            types.SimpleNamespace(shape=shape, mesh_dim_names=axes))


def _rules(name, i):
    multi_pod = "pod" in MESHES[i][1]
    return getattr(JS, name)(multi_pod), getattr(TS, name)(multi_pod)


def _flat(tree, pre=""):
    """Nested dicts -> {path: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


@pytest.fixture
def jax_specs(monkeypatch):
    """The JAX functions that wrap each spec in a ``NamedSharding`` of the
    stand-in mesh return the spec instead."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


GRID = [(r, m) for r in RULES for m in range(len(MESHES))]


@pytest.mark.parametrize("rules,mesh", GRID)
def test_param_specs_agree(rules, mesh, jax_specs):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(rules, mesh)
    for arch in list_archs():
        jtree = JM.build_param_specs(jax_get_config(arch))
        ttree = TM.build_param_specs(get_config(arch))
        jl, tl = _flat(jtree), _flat(ttree)
        assert jl.keys() == tl.keys(), arch
        jsh = _flat(JS.param_shardings(jm, jr, jtree))
        tsh = _flat(TS.param_shardings(tm, tr, ttree))
        jpt = _flat(JParams.partition_tree(jtree, jr.params, MESHES[mesh][1]))
        tpt = _flat(TParams.partition_tree(ttree, tr.params, MESHES[mesh][1]))
        for path, s in tl.items():
            assert (s.shape, s.axes) == (jl[path].shape, jl[path].axes)
            ts = TS.spec_for(tm, tr.params, s.axes, s.shape)
            assert tuple(ts) == tuple(jsh[path]), (arch, path)
            assert tsh[path] == (tm, TS.placements(tm, ts)), (arch, path)
            assert tuple(tpt[path]) == tuple(jpt[path]), (arch, path)


@pytest.fixture
def loops(monkeypatch):
    """The JAX package's scans as Python loops, its remat as a plain
    call."""
    monkeypatch.setattr(jax.lax, "scan", _py_scan)
    monkeypatch.setattr(jax, "checkpoint", lambda f, *a, **k: f)


def _py_scan(f, init, xs, length=None, unroll=1, **_):
    """``lax.scan`` as a Python loop: the body runs once per step."""
    n = jax.tree_util.tree_leaves(xs)[0].shape[0] if xs is not None \
        else length
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if ys and jax.tree_util.tree_leaves(ys[0]):
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)
    return carry, ys[0] if ys else None


def _recorder():
    calls = []

    def hook(x, names):
        calls.append((tuple(names), tuple(int(d) for d in x.shape)))
        return x
    return calls, hook


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jax_get_config(arch).replace(dtype="float32")
    tcfg = get_config(arch).replace(dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seq, seed=0):
    tk = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq))
    return tk.astype(np.int32)


def _run_jax(arch, fn):
    jcfg, _, jp, _ = _pair(arch)
    calls, hook = _recorder()
    tk = _tokens(jcfg, S)
    with jax.disable_jit():
        if fn == "forward":
            JM.forward(jcfg, jp, {"tokens": jnp.asarray(tk)}, mode="train",
                       shard=hook)
        elif fn == "prefill":
            JM.forward(jcfg, jp, {"tokens": jnp.asarray(tk)}, mode="prefill",
                       shard=hook)
        elif fn == "train_loss":
            JM.train_loss(jcfg, jp, {"tokens": jnp.asarray(tk),
                                     "labels": jnp.asarray(tk)},
                          shard=hook, loss_chunks=2)
        elif fn == "decode_step":
            state = JM.init_decode_state(jcfg, B, S)
            state["lengths"] = jnp.asarray([3, 7], jnp.int32)
            JM.decode_step(jcfg, jp, state, {"tokens": jnp.asarray(tk[:, :1])},
                           shard=hook)
        else:
            raise ValueError(fn)
    return calls


def _run_port(arch, fn):
    _, tcfg, _, tp = _pair(arch)
    calls, hook = _recorder()
    tk = torch.tensor(_tokens(tcfg, S))
    with torch.no_grad():
        if fn == "forward":
            TM.forward(tcfg, tp, {"tokens": tk}, mode="train", shard=hook)
        elif fn == "prefill":
            TM.forward(tcfg, tp, {"tokens": tk}, mode="prefill", shard=hook)
        elif fn == "train_loss":
            TM.train_loss(tcfg, tp, {"tokens": tk, "labels": tk}, shard=hook,
                          loss_chunks=2)
        elif fn == "decode_step":
            state = TM.init_decode_state(tcfg, B, S, device="cpu")
            state["lengths"] = torch.tensor([3, 7], dtype=torch.int32)
            TM.decode_step(tcfg, tp, state, {"tokens": tk[:, :1]},
                           shard=hook)
    if fn == "train_step":
        from repro_torch.train.optim import init_state
        step = TStep.make_train_step(tcfg, shard=hook, microbatches=2)
        step(tp, init_state(tp), {"tokens": tk, "labels": tk})
    return calls


FNS = ["forward", "prefill", "train_loss", "decode_step"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("arch", HOOK_ARCHS)
def test_hooks_see_the_reference_calls(arch, fn, loops):
    want = _run_jax(arch, fn)
    assert want                                  # the hooks were reached
    assert _run_port(arch, fn) == want


@pytest.mark.parametrize("arch", HOOK_ARCHS)
def test_train_step_lays_out_microbatches_as_the_reference(arch):
    """``_reshard_micro``: each batch leaf as (mb, B/mb, S) with its batch
    dim named (the reference's ``(None, "batch", None)``), before the first
    microbatch's loss, whose calls are ``train_loss``'s."""
    got = _run_port(arch, "train_step")
    assert got[:2] == [((None, "batch", None), (2, 1, S))] * 2
    _, tcfg, _, tp = _pair(arch)
    calls, hook = _recorder()
    tk = torch.tensor(_tokens(tcfg, S))[:1]
    TM.train_loss(tcfg, tp, {"tokens": tk, "labels": tk}, shard=hook)
    assert got[2:2 + len(calls)] == calls


def _activation_cases():
    """Every (names, shape) the hooks receive in the recorded runs, and the
    same names at shapes that the large meshes divide and do not."""
    seen = set()
    for arch in HOOK_ARCHS:
        for fn in FNS:
            seen.update(_run_port(arch, fn))
    seen.update({((None, "batch", None), (2, 1, S)),
                 ((None, None, "batch", None), (2, 3, 1, S))})
    out = set()
    for names, shape in seen:
        for k in (1, 16, 48):
            out.add((names, tuple(d * k for d in shape)))
    return sorted(out, key=repr)


@pytest.mark.parametrize("rules,mesh", GRID)
def test_activation_specs_agree(rules, mesh):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(rules, mesh)
    cases = _activation_cases()
    assert len({names for names, _ in cases}) >= 6
    for names, shape in cases:
        assert tuple(TS.spec_for(tm, tr.acts, names, shape)) == \
            tuple(JS.spec_for(jm, jr.acts, names, shape)), (names, shape)


@pytest.mark.parametrize("rules,mesh", GRID)
def test_batch_and_decode_state_specs_agree(rules, mesh, jax_specs):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(rules, mesh)
    for b in (1, 3, 32, 48, 512):
        jb = {"tokens": jax.ShapeDtypeStruct((b, 64), jnp.int32),
              "labels": jax.ShapeDtypeStruct((b, 64), jnp.int32),
              "positions": jax.ShapeDtypeStruct((3, b, 64), jnp.int32),
              "frames": jax.ShapeDtypeStruct((b, 64, 32), jnp.float32)}
        tb = {k: TM.TensorSpec(v.shape, torch.int32) for k, v in jb.items()}
        js, ts = JS.batch_shardings(jm, jr, jb), TS.batch_shardings(tm, tr, tb)
        for k in jb:
            assert ts[k] == (tm, TS.placements(tm, TS.P(*js[k]))), (b, k)
    for arch in list_archs():
        for b, s in ((4, 64), (32, 4096)):
            jl = _flat(JS.decode_state_shardings(
                jm, jr, None, JM.decode_state_specs(jax_get_config(arch), b,
                                                    s)))
            tl = _flat(TS.decode_state_shardings(
                tm, tr, None, TM.decode_state_specs(get_config(arch), b, s)))
            assert jl.keys() == tl.keys(), arch
            for path, js in jl.items():
                assert tl[path] == (tm, TS.placements(tm, TS.P(*js))), \
                    (arch, path)


def test_placements_name_each_axis_once():
    _, tm = _meshes(2)
    from torch.distributed.tensor import Replicate, Shard
    assert TS.placements(tm, TS.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert TS.placements(tm, TS.P(None, None)) == (Replicate(),) * 3
    assert mesh_mod.dp_axes(tm) == ("pod", "data")


def test_make_mesh_needs_a_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh((1, 2), ("data", "model"))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return run_world(sharding_world, 4, tmp_path_factory.mktemp("sharding"),
                     timeout=180)


def test_shard_fn_redistributes_dtensors_in_a_gloo_world(gloo):
    for rank, res in enumerate(gloo):
        assert len(res["acts"]) == 12
        for rec in res["acts"]:
            assert rec["placements"] and rec["full"] and rec["plain"], \
                (rank, rec)


def test_two_axes_shard_one_dim_pod_outermost(gloo):
    for res in gloo:
        assert all(res["two_axes"])


def test_params_placed_by_their_rule_and_mesh_size_checked(gloo):
    for res in gloo:
        assert all(res["param"]) and res["too_few"]
