"""The port's cells computing on their shards (``launch.cells``:
tensor-parallel attention and MLP over ``model``, the vocab-parallel
embedding, head and loss, per-period FSDP gathers, sequence parallelism,
weight-stationary serving) in one gloo world of 4 processes.

Cases: the five dense smoke configs (H 4, KV 2, hd 16): qwen3-1.7b (tied
embeddings), llama3-8b, starcoder2-7b (layernorm biases, GELU, tied),
qwen2-vl-7b (M-RoPE, vision embeddings) and hubert-xlarge (frames,
non-causal), each on a (2, 2) and a (1, 4) ("data", "model") mesh. Two
train steps of 8 x 16 tokens under ``baseline_rules`` and ``sp_rules``,
each from the JAX package's state before it (the initial parameters,
f32, then its first step's), against the JAX package's
``make_train_step`` on the global batch at
``test_torch_sharded_train.py``'s pins; prefill and decode cells (with
and without the distributed flash-decode) under ``serve_rules`` against
the port's unsharded calls. Two configs derived from qwen3-1.7b-smoke
take the other paths: H 3 (KV 1) on a model extent of 2 splits the head
projection mid-head, so each rank's 1.5 heads of q columns are exchanged
onto head slots of 2 and 1 heads (``TPContext.to_heads``) and its output
back; H 6 (KV 3) gives rank 0 q heads 0-2, which read KV heads 0, 0, 1,
so the rank repeats its KV heads for the kernel.

In the world every call's collectives are recorded by a test-only patch
of ``torch.distributed`` (``_torch_dist_worker.CollectiveLog``): no rank
all-gathers an ``attn``-kind leaf over ``model``, none reaches DTensor's
own collectives, and each rank's count of collectives and their ring wire
bytes (an all-to-all's: the bytes the rank receives) equal
``launch.dryrun.account``'s for the same cell."""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_world, tensor_parallel_world
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
from repro_torch.train import step as TS
from test_torch_sharded_train import (LOSS_RTOL, MOMENT_TOL, NORM_RTOL,
                                      PARAM_ATOL)

torch.set_num_threads(1)

ARCHS = ("qwen3-1.7b", "llama3-8b", "starcoder2-7b", "qwen2-vl-7b",
         "hubert-xlarge")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# H 3 on a model extent of 2 splits the head projection mid-head: slots
# of 2 and 1 heads (the cases keep the name from when such a split took
# the guard)
GUARD = (("num_heads", 3), ("num_kv_heads", 1))
UNEVEN = (("num_heads", 6), ("num_kv_heads", 3))
B, S = 8, 16
SEEDS = (31, 32)
CACHE, LENGTHS = 16, [3, 9, 15, 0]
# the serve cells against the port's unsharded calls (f32)
SERVE_ATOL = 2e-5
# the wire bytes of the recorded collectives against the dry run's: the
# same ring model summed in another order
WIRE_RTOL = 1e-9
# AdamW's step on a gradient element within f32 rounding of zero: where
# |g| is near eps (1e-8) the step g / (|g| + eps) follows the rounding of
# the sums, which the shards order otherwise. The gradients themselves
# agree to 6e-7 of their leaf's max (starcoder2-7b-smoke, both steps), so
# an element whose reference gradient at a step is within ROUND_ZERO of
# its leaf's max may leave PARAM_ATOL, by at most what the steps can move
# it (2 lr a step), and at most ROUND_FLIPS such elements a step. Each
# step starts from the JAX package's state, so no such element carries
# into the next step's gradients. Readings: 2, 2 and 1 elements in the
# first step of starcoder2-7b-smoke's (2, 2) baseline, (2, 2) sp and
# (1, 4) baseline cases, 0 elsewhere (embed, |g| 1.0e-8 of its leaf's max
# 7.5e-2; wk, |g| 3.8e-9 of 5.6e-3)
ROUND_ZERO = 1e-6
ROUND_FLIPS = 3

TRAIN = {f"{a}-{m}-{r.split('_')[0]}": (a, m, r, ())
         for a in ARCHS for m in MESHES for r in ("baseline_rules",
                                                   "sp_rules")}
TRAIN.update({"guard-H3-baseline": ("qwen3-1.7b", "2x2", "baseline_rules",
                                    GUARD),
              "guard-H3-sp": ("qwen3-1.7b", "2x2", "sp_rules", GUARD),
              "uneven-H6-KV3": ("qwen3-1.7b", "2x2", "baseline_rules",
                                UNEVEN)})
SERVE = {f"{a}-{m}": (a, m, ()) for a in ARCHS for m in MESHES}
SERVE.update({"guard-H3": ("qwen3-1.7b", "2x2", GUARD),
              "uneven-H6-KV3": ("qwen3-1.7b", "2x2", UNEVEN)})


@functools.lru_cache(maxsize=None)
def _pair(arch, over=()):
    jcfg = jax_get_config(arch + "-smoke").replace(dtype="float32",
                                                    **dict(over))
    tcfg = get_config(arch + "-smoke").replace(dtype="float32", **dict(over))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _batches(arch, over=()):
    jcfg, tcfg, _, _ = _pair(arch, over)
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


def _np_state(params, state) -> dict:
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "mu": as_np(state.mu),
            "nu": as_np(state.nu), "step": int(state.step)}


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, over=()):
    """The JAX package's two steps on the global batches, each as
    {"start": the state before it (numpy), "metrics", "end": the state
    after it, "grads": its gradient leaves from the first moments}."""
    jcfg, _, jp, _ = _pair(arch, over)
    step = JS.make_train_step(jcfg)
    b1 = JO.AdamWConfig().b1
    params, state, out = jp, JO.init_state(jp), []
    for b, _ in _batches(arch, over):
        start = _np_state(params, state)
        params, state, m = step(params, state, b)
        end = _np_state(params, state)
        grads = [(np.asarray(n, np.float64) - b1 * np.asarray(o, np.float64))
                 / (1 - b1) for n, o in zip(
                     jax.tree_util.tree_leaves(end["mu"]),
                     jax.tree_util.tree_leaves(start["mu"]))]
        out.append({"start": start, "end": end, "grads": grads,
                    "metrics": {k: float(v) for k, v in m.items()}})
    return out


@functools.lru_cache(maxsize=None)
def _serve_inputs(arch, over=()):
    _, tcfg, _, _ = _pair(arch, over)
    inputs = TD.synthetic_batch_for(tcfg, ShapeSpec("p", S, 4, "prefill"),
                                    seed=7, device="cpu")
    out = {"inputs": {k: v.numpy() for k, v in inputs.items()}}
    if not tcfg.is_decoder:
        return out
    rng = np.random.default_rng(8)
    state = tree_map(lambda t: t.numpy(),
                     TM.init_decode_state(tcfg, 4, CACHE, device="cpu"))
    state["caches"] = tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        state["caches"])
    state["lengths"] = np.asarray(LENGTHS, np.int32)
    out.update(state=state, cache=CACHE,
               next=rng.integers(0, tcfg.vocab_size, (4, 1)).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    train = [dict(arch=arch + "-smoke", mesh=MESHES[m], rules=rules,
                  microbatches=1, cfg=dict(over),
                  starts=[s["start"] for s in _jax_steps(arch, over)],
                  batches=[b for _, b in _batches(arch, over)])
             for arch, m, rules, over in TRAIN.values()]
    serve = [dict(arch=arch + "-smoke", mesh=MESHES[m], rules="serve_rules",
                  cfg=dict(over), params=_pair(arch, over)[3],
                  **_serve_inputs(arch, over))
             for arch, m, over in SERVE.values()]
    out = run_world(tensor_parallel_world, 4,
                    tmp_path_factory.mktemp("tp"), train, serve, timeout=900)
    return ([dict(zip(TRAIN, r["train"])) for r in out],
            [dict(zip(SERVE, r["serve"])) for r in out])


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("label", list(TRAIN))
def test_train_cell_matches_jax(world, label):
    """Each of two steps, from the JAX package's state before it: loss,
    grad norm, params and AdamW moments against its ``make_train_step``
    on the global batch."""
    arch, _, _, over = TRAIN[label]
    lr = JO.AdamWConfig().lr
    for i, (got, want) in enumerate(zip(world[0][0][label]["steps"],
                                        _jax_steps(arch, over))):
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   want["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"],
                                   rtol=NORM_RTOL)
        assert got["step"] == i + 1 and got["placements_kept"]
        past = 0
        for w, g, gr in zip(jax.tree_util.tree_leaves(want["end"]["params"]),
                            tree_leaves(got["params"]), want["grads"]):
            diff = np.abs(g - np.asarray(w, np.float64))
            near = np.abs(gr) <= ROUND_ZERO * np.abs(gr).max()
            far = diff > PARAM_ATOL
            past += int(far.sum())
            assert not (far & ~near).any(), (i, diff.max())
            assert (diff <= PARAM_ATOL + 2 * lr).all(), i
        assert past <= ROUND_FLIPS, (i, past)
        for name in ("mu", "nu"):
            for w, g in zip(jax.tree_util.tree_leaves(want["end"][name]),
                            tree_leaves(got[name])):
                _close_rel(g, w, MOMENT_TOL)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_match_unsharded(world, label):
    """The prefill cell's last-token logits (sharded over the vocabulary
    where the head is) and caches, and a decode step's logits and state,
    with and without the distributed flash-decode, gathered whole,
    against the port's unsharded calls on the same inputs."""
    arch, _, over = SERVE[label]
    got = world[1][0][label]
    _, tcfg, _, np_p = _pair(arch, over)
    ins = _serve_inputs(arch, over)
    params = params_from_numpy(np_p, "cpu")
    tol = dict(rtol=0, atol=SERVE_ATOL)
    with torch.no_grad():
        logits, pstate = TS.make_prefill_step(tcfg)(
            params, {k: torch.from_numpy(v) for k, v in ins["inputs"].items()})
    np.testing.assert_allclose(got["prefill_logits"], logits.numpy(), **tol)
    assert got["prefill_placements"][-1] == "S(1)"      # vocab on model
    for w, g in zip(tree_leaves(pstate["caches"]),
                    tree_leaves(got["prefill_state"]["caches"])):
        np.testing.assert_allclose(g, w.numpy(), **tol)
    if not tcfg.is_decoder:
        assert "decode" not in got
        return
    for dist_decode, dec in got["decode"].items():
        state = tree_map(torch.from_numpy, ins["state"])
        with torch.no_grad():
            want, new = TS.make_decode_step(tcfg)(
                params, state, {"tokens": torch.from_numpy(ins["next"])})
        np.testing.assert_allclose(dec["logits"], want.numpy(), **tol)
        for w, g in zip(tree_leaves(new["caches"]),
                        tree_leaves(dec["state"]["caches"])):
            np.testing.assert_allclose(g, w.numpy(), **tol)
        np.testing.assert_array_equal(dec["state"]["lengths"],
                                      new["lengths"].numpy())
        assert dec["placements_kept"], dist_decode


CASES = [f"train:{k}" for k in TRAIN] + [f"serve:{k}" for k in SERVE]


def _case(world, label):
    """(the case's config overrides, rank 0's result, every rank's
    recorded calls as (what, tally, account, model gathers))."""
    kind, key = label.split(":", 1)
    calls = []
    if kind == "train":
        over = TRAIN[key][3]
        for rank in world[0]:
            res = rank[key]
            calls += [(f"train step {i}", s["tally"], res["account"],
                       s["model_gathers"])
                      for i, s in enumerate(res["steps"])]
        return over, world[0][0][key], calls
    over = SERVE[key][2]
    for rank in world[1]:
        res = rank[key]
        p = res["prefill"]
        calls.append(("prefill", p["tally"], p["account"],
                      p["model_gathers"]))
        for d, dec in res.get("decode", {}).items():
            calls.append((f"decode dist={d}", dec["tally"], dec["account"],
                          dec["model_gathers"]))
    return over, world[1][0][key], calls


@pytest.mark.parametrize("label", CASES)
def test_no_attn_leaf_gathered_over_model(world, label):
    """No rank all-gathers an ``attn``-kind leaf over ``model`` (its
    block, or a period's slice of it), and none reaches DTensor's own
    collectives; no cell takes a guard, the mid-head H 3 case included
    (its attention computes on head slots)."""
    over, res, calls = _case(world, label)
    assert res["guarded"] == ()
    for what, tally, _, gathers in calls:
        assert not [k for k in tally if k.startswith("functional:")], what
        assert not gathers, (what, gathers)


@pytest.mark.parametrize("label", CASES)
def test_collectives_match_the_dry_run(world, label):
    """Each rank's collectives a call (count and ring wire bytes, by
    kind) equal ``dryrun.account``'s for the same cell."""
    for what, tally, account, _ in _case(world, label)[2]:
        assert set(tally) == set(account), (what, tally, account)
        for kind, (n, wire) in account.items():
            assert tally[kind][0] == n, (what, kind, tally[kind], n)
            assert tally[kind][1] == pytest.approx(wire, rel=WIRE_RTOL,
                                                   abs=1e-6), (what, kind)


# ------------------------------------------------ chip_smoke rehearsal


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke imported by name (its world's spawned ranks unpickle
    their function from it)."""
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_world_of_two_rehearsed(smoke):
    """chip_smoke's world of two at smoke size on the CPU: no collective
    refused, and the cells against the world of one at the pins (the
    phase checks itself)."""
    out = smoke.tp_world_phase("cpu", arch="qwen3-1.7b-smoke", layers=2,
                               batch=2, seq=16, cache=16)
    assert not out["refused"]
    assert out["train"]["update_excess"] <= 0
    assert set(out["decode"]) == {False, True}
    # each of 2 layers: a forward and its recompute, one backward
    launches = out["launches"]
    assert launches["train"]["flash_attention"] == 4
    assert launches["train"]["flash_attention_backward"] == 2
    assert launches["prefill"]["flash_attention"] == 2
    assert launches["decode dist=False"]["decode_attention"] == 2
    assert launches["decode dist=True"]["decode_attention_partial"] == 2


def test_per_rank_kernel_phase_rehearsed(smoke):
    """chip_smoke's per-rank attention cases through the plain versions
    on the CPU, at a group of 3 (internlm2-20b's on 16 model ranks)."""
    out = smoke.tp_kernel_phase("cpu", heads=[("internlm2 tp16", 3, 1)],
                                time_it=False)
    for name in ("flash_attention", "flash_attention_backward",
                 "decode_attention"):
        (rec,) = out[name]
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name
