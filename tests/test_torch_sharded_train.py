"""The port's train cell on a mesh (``launch.cells.build_cell``'s train
``fn``) in one gloo world of 4 processes, against the port's unsharded
``make_train_step`` on the global batch and against the JAX package's.

Cases: qwen3-1.7b-smoke on a (2, 2) ("data", "model") mesh under
``baseline_rules`` and ``sp_rules`` at microbatches 1 and 2;
zamba2-2.7b-smoke; dbrx-132b-smoke (MoE, ``moe_groups`` = the mesh size,
the reference's groups over the global batch); qwen3-1.7b-smoke on a
(2, 1, 2) ("pod", "data", "model") mesh with ``compress_with_feedback``
as the gradient hook. Two steps of 8 x 16 tokens from the JAX package's
initial parameters (f32): the loss, the grad norm, the params and the
AdamW moments (gathered whole), the step count, and every leaf still at
its placements. Then the prefill and decode cells (``baseline_rules``,
and ``serve_rules`` with the distributed flash-decode) against the
unsharded calls. The world bodies live in ``tests/_torch_dist_worker.py``
(spawned workers import no JAX)."""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_world, sharded_train_world
from repro.arch import model as JM
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as JD
from repro.distributed import compression as JC
from repro.train import optim as JO
from repro.train import step as JS
from repro_torch.arch import model as TM
from repro_torch.arch.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import synthetic as TD
from repro_torch.distributed import compression as TC
from repro_torch.launch.cells import local_moe_groups, train_split
from repro_torch.launch.mesh import MeshShape
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

torch.set_num_threads(1)

# tests/test_torch_lm_train.py's pins against the JAX package: the loss
# (the same f32 sums in other orders), the grad norm, the params after
# the AdamW steps (absolute), and a gradient leaf's max |diff| over its
# max |ref| (the moments here)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 2e-5
MOMENT_TOL = 1e-4
# the int8-hook case: a gradient element within f32 rounding of a code
# boundary may round to the neighbouring code on one side only (the two
# sum in other orders). At most HOOK_FLIPS elements of a moment tree (of
# 82,304) may then differ past MOMENT_TOL, each by at most what one code
# moves it. Readings, in mu and in nu alike: 1 element against the
# port's unsharded step, 2 against the JAX package's
HOOK_FLIPS = 3
B, S = 8, 16
MESH = ((2, 2), ("data", "model"))
POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
TRAIN = {
    "qwen3-baseline-mb1": ("qwen3-1.7b", MESH, "baseline_rules", 1, False),
    "qwen3-baseline-mb2": ("qwen3-1.7b", MESH, "baseline_rules", 2, False),
    "qwen3-sp-mb1": ("qwen3-1.7b", MESH, "sp_rules", 1, False),
    "qwen3-sp-mb2": ("qwen3-1.7b", MESH, "sp_rules", 2, False),
    "zamba2": ("zamba2-2.7b", MESH, "baseline_rules", 1, False),
    "dbrx-moe": ("dbrx-132b", MESH, "baseline_rules", 1, False),
    "qwen3-pod-hook": ("qwen3-1.7b", POD_MESH, "baseline_rules", 1, True),
}
SERVE = {"baseline": ("baseline_rules", False),
         "serve-dist-decode": ("serve_rules", True)}
STEPS, SEEDS = 2, (31, 32)
CACHE, LENGTHS = 16, [3, 9, 15, 0]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jax_get_config(arch + "-smoke").replace(dtype="float32")
    tcfg = get_config(arch + "-smoke").replace(dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _batches(arch):
    jcfg, tcfg, _, _ = _pair(arch)
    out = []
    for seed in SEEDS:
        jb = JD.synthetic_batch_for(jcfg, JShapeSpec("t", S, B, "train"),
                                    seed=seed)
        tb = TD.synthetic_batch_for(tcfg, ShapeSpec("t", S, B, "train"),
                                    seed=seed, device="cpu")
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
        out.append((jb, {k: v.numpy() for k, v in tb.items()}))
    return out


def _serve_inputs():
    _, tcfg, _, np_p = _pair("qwen3-1.7b")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, tcfg.vocab_size, (4, S)).astype(np.int32)
    state = TM.init_decode_state(tcfg, 4, CACHE, device="cpu")
    state = tree_map(lambda t: t.numpy(), state)
    state["caches"] = tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        state["caches"])
    state["lengths"] = np.asarray(LENGTHS, np.int32)
    nxt = rng.integers(0, tcfg.vocab_size, (4, 1)).astype(np.int32)
    return np_p, tokens, state, nxt


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    train = []
    for label, (arch, (shape, axes), rules, mb, hook) in TRAIN.items():
        train.append(dict(arch=arch + "-smoke", mesh=shape, axes=axes,
                          rules=rules, microbatches=mb, hook=hook,
                          params=_pair(arch)[3],
                          batches=[b for _, b in _batches(arch)]))
    np_p, tokens, state, nxt = _serve_inputs()
    serve = [dict(arch="qwen3-1.7b-smoke", mesh=MESH[0], axes=MESH[1],
                  rules=rules, dist_decode=dist, params=np_p, tokens=tokens,
                  cache=CACHE, state=state, next=nxt, steps=1)
             for rules, dist in SERVE.values()]
    out = run_world(sharded_train_world, 4,
                    tmp_path_factory.mktemp("sharded"), train, serve,
                    timeout=600)[0]
    return (dict(zip(TRAIN, out["train"])), dict(zip(SERVE, out["serve"])))


def _port_hook(scales):
    """``FeedbackHook``; each call's per-leaf scales appended to
    ``scales``."""
    inner = TC.FeedbackHook()

    def hook(grads):
        errors = tree_leaves(inner.error) if inner.error is not None \
            else [0.0] * len(tree_leaves(grads))
        scales.append([float(TC.quantize_int8(g + e)[1]) for g, e in
                       zip(tree_leaves(grads), errors)])
        return inner(grads)
    return hook


def _jax_hook(scales):
    """The JAX package's ``compress_with_feedback`` as a hook, its error
    state threaded; each call's per-leaf scales appended to ``scales``."""
    err = {}

    def hook(grads):
        if "e" not in err:
            err["e"] = JC.init_error_state(grads)
        scales.append([float(JC.quantize_int8(g + e)[1]) for g, e in zip(
            jax.tree_util.tree_leaves(grads),
            jax.tree_util.tree_leaves(err["e"]))])
        grads, err["e"] = JC.compress_with_feedback(grads, err["e"])
        return grads
    return hook


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= tol, err


def _moe_kw(arch):
    return {"moe_groups": 4} if arch.startswith("dbrx") else {}


def _check_moments(got, want: dict, scales, hook: bool):
    """``got``'s moments (gathered whole) against ``want`` ({"mu", "nu"}:
    leaves in ``tree_leaves`` order): each leaf within ``MOMENT_TOL`` of
    its max, or with the int8 hook at most ``HOOK_FLIPS`` elements of a
    moment tree past it, each within one code's move (``_one_code``)."""
    for name in ("mu", "nu"):
        pairs = list(zip(want[name], tree_leaves(got[name])))
        if not hook:
            for w, g in pairs:
                _close_rel(g, w, MOMENT_TOL)
            continue
        past = 0
        for (w, g), code in zip(pairs, _one_code(scales, TO.AdamWConfig(),
                                                 name)):
            w = np.asarray(w, np.float64)
            diff = np.abs(g - w)
            bound = MOMENT_TOL * np.abs(w).max()
            past += int((diff > bound).sum())
            assert (diff <= bound + code).all(), name
        assert past <= HOOK_FLIPS, (name, past)


def _one_code(scales, opt, moment: str) -> list:
    """Per leaf, how far one int8 code of difference in each step's
    compressed gradient (and the error feedback carrying it into the next
    step's input, one more code) moves a moment after these steps: mu by
    (1 - b1) s_t for each code, nu by (1 - b2) (2 |g| s_t + s_t^2) with
    |g| <= 127 s_t."""
    out = []
    for per_leaf in zip(*scales):
        if moment == "mu":
            out.append(2 * sum((1 - opt.b1) * s for s in per_leaf))
        else:
            out.append(2 * sum((1 - opt.b2) * 255 * s * s for s in per_leaf))
    return out


@pytest.mark.parametrize("label", list(TRAIN))
def test_sharded_step_equals_unsharded(world, label):
    """Loss, grad norm, params and moments against the unsharded step.
    With the int8 hook a gradient element whose value sits within f32
    rounding of a code boundary may round to the neighbouring code on one
    side (the two sum in other orders): the params, whose first AdamW
    steps move by about lr sign(g), hold at ``PARAM_ATOL`` all the same;
    such an element of a moment may differ by what one code moves it
    (``HOOK_FLIPS`` of them at most)."""
    arch, _, _, mb, hook = TRAIN[label]
    got = world[0][label]
    _, tcfg, _, np_p = _pair(arch)
    scales = []
    step = TS.make_train_step(tcfg, microbatches=mb, **_moe_kw(arch),
                              grad_hook=_port_hook(scales) if hook else None)
    params = params_from_numpy(np_p, "cpu")
    state = TO.init_state(params)
    for (_, b), m in zip(_batches(arch), got["metrics"]):
        params, state, want = step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == set(want)
        for key in want:
            tol = NORM_RTOL if key == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(m[key], float(want[key]), rtol=tol)
    assert got["step"] == STEPS and got["placements_kept"]
    assert got["microbatches"] == mb
    for w, g in zip(tree_leaves(params), tree_leaves(got["params"])):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=PARAM_ATOL)
    _check_moments(got, {name: [w.numpy() for w in tree_leaves(
        getattr(state, name))] for name in ("mu", "nu")}, scales, hook)


@pytest.mark.parametrize("label", list(TRAIN))
def test_sharded_step_equals_jax(world, label):
    """Loss, grad norm, params and moments against the JAX package's
    ``make_train_step`` on the global batch, as against the port's."""
    arch, _, _, mb, hook = TRAIN[label]
    got = world[0][label]
    jcfg, _, jp, _ = _pair(arch)
    scales = []
    step = JS.make_train_step(jcfg, microbatches=mb, **_moe_kw(arch),
                              grad_hook=_jax_hook(scales) if hook else None)
    params, state = jp, JO.init_state(jp)
    for (b, _), m in zip(_batches(arch), got["metrics"]):
        params, state, want = step(params, state, b)
        np.testing.assert_allclose(m["loss"], float(want["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], float(want["grad_norm"]),
                                   rtol=NORM_RTOL)
    for w, g in zip(jax.tree_util.tree_leaves(params),
                    tree_leaves(got["params"])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_ATOL)
    _check_moments(got, {name: [np.asarray(w) for w in jax.tree_util.
                                tree_leaves(getattr(state, name))]
                         for name in ("mu", "nu")}, scales, hook)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_equal_unsharded(world, label):
    """The prefill cell's logits and caches, and one decode cell step's
    logits and state, gathered whole, against the unsharded calls on the
    same inputs (f32; the distributed flash-decode combines two sequence
    shards)."""
    got = world[1][label]
    _, tcfg, _, _ = _pair("qwen3-1.7b")
    np_p, tokens, state, nxt = _serve_inputs()
    params = params_from_numpy(np_p, "cpu")
    with torch.no_grad():
        logits, pstate = TS.make_prefill_step(tcfg)(
            params, {"tokens": torch.from_numpy(tokens)})
        dstate = tree_map(torch.from_numpy, state)
        dlogits, dnew = TS.make_decode_step(tcfg)(
            params, dstate, {"tokens": torch.from_numpy(nxt)})
    tol = dict(rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["prefill_logits"], logits.numpy(), **tol)
    for w, g in zip(tree_leaves(pstate["caches"]),
                    tree_leaves(got["prefill_state"]["caches"])):
        np.testing.assert_allclose(g, w.numpy(), **tol)
    np.testing.assert_array_equal(got["prefill_state"]["lengths"],
                                  pstate["lengths"].numpy())
    np.testing.assert_allclose(got["decode_logits"], dlogits.numpy(), **tol)
    for w, g in zip(tree_leaves(dnew["caches"]),
                    tree_leaves(got["decode_state"]["caches"])):
        np.testing.assert_allclose(g, w.numpy(), **tol)
    np.testing.assert_array_equal(got["decode_state"]["lengths"],
                                  dnew["lengths"].numpy())
    assert got["state_placements_kept"]


@pytest.mark.parametrize("shape,rows,want", [
    ((2, 2), 8, 4), ((2, 2), 2, 2), ((2, 4), 16, 8), ((16, 16), 128, 128),
    ((2, 16, 16), 256, 256), ((1, 1), 4, 1)])
def test_train_split(shape, rows, want):
    """A training microbatch's rows spread over gcd(ranks, rows) slices."""
    axes = ("pod", "data", "model")[-len(shape):]
    assert train_split(MeshShape(shape, axes), rows) == want


def test_local_moe_groups_keep_the_reference_groups():
    """A rank's share of the reference's token groups: the global
    microbatch's groups (``dispatch_geometry``, lowered until they divide
    the tokens) over the slices; a dense model keeps its argument."""
    cfg = get_config("dbrx-132b-smoke")
    assert local_moe_groups(cfg, 8 * 16, 4, 4) == 1
    assert local_moe_groups(cfg, 8 * 16, 8, 2) == 4
    assert local_moe_groups(cfg, 6, 4, 3) == 1          # 4 -> 3 groups
    with pytest.raises(ValueError):
        local_moe_groups(cfg, 6, 4, 2)                   # 3 groups, 2 slices
    assert local_moe_groups(get_config("qwen3-1.7b-smoke"), 6, 4, 2) == 4
