"""rwkv6's cells computing on their shards (``arch/rwkv6.py``'s time-mix on
its WKV heads and channel-mix on its columns, through ``launch.cells``) in
one gloo world of 4 processes.

Cases: rwkv6-7b-smoke (d 64, 4 WKV heads of K 16, d_ff 128) on a (2, 2)
and a (1, 4) ("data", "model") mesh: 2 or 1 heads a rank. Two train steps
of 8 x 16 tokens under ``baseline_rules`` and ``sp_rules``, each from the
JAX package's state before it, against the JAX package's
``make_train_step`` on the global batch at ``test_torch_sharded_train.py``'s
pins; prefill and decode cells (with and without the distributed
flash-decode flag, which an attention-free model ignores) under
``serve_rules`` against the JAX package's ``make_prefill_step`` and
``make_decode_step`` at ``SERVE_ATOL``: logits, ``x_tm``, ``x_cm`` and
``wkv``. A guard case, d_model 48 (3 heads of K 16) on (1, 4): each rank's
12 of 48 columns cut a head, so the time-mix's leaves are gathered over
``model`` and computed replicated (``Cell.guarded``) while the
channel-mix still splits. Three planted faults the pins must catch: the
lerp's ``lora_A`` and the group norm's ``ln_x_scale`` without their sum
over ``model``, and the channel-mix's gate combine with an identity
backward.

Every call's collectives are recorded (``_torch_dist_worker.
CollectiveLog``): no call all-gathers an RWKV6 weight over ``model`` (the
guard's time-mix leaves, gathered once a call, aside); none reaches
DTensor's own collectives; each rank's count of collectives and their
ring wire bytes equal ``launch.dryrun.account``'s. The last tests rehearse
``chip_smoke.py``'s phase 20 and its per-rank WKV cases at smoke size."""
import functools

import jax
import jax.numpy as jnp
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
from repro_torch.arch.params import tree_leaves, tree_map
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import synthetic as TD
from test_torch_mamba_parallel import _close_rel, _np_state
from test_torch_sharded_train import (LOSS_RTOL, MOMENT_TOL, NORM_RTOL,
                                      PARAM_ATOL)
from test_torch_tensor_parallel import (CACHE, LENGTHS, ROUND_FLIPS,
                                        ROUND_ZERO, SERVE_ATOL, WIRE_RTOL)

torch.set_num_threads(1)

ARCH = "rwkv6-7b"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# 3 WKV heads (d 48 of K 16) on a model extent of 4: the time-mix's guard
GUARD = (("d_model", 48),)
B, S = 8, 16
SEEDS = (41, 42)

TRAIN = {f"{m}-{r.split('_')[0]}": (m, r, ())
         for m in MESHES for r in ("baseline_rules", "sp_rules")}
TRAIN.update({"guard-1x4-baseline": ("1x4", "baseline_rules", GUARD),
              "guard-1x4-sp": ("1x4", "sp_rules", GUARD)})
# the planted faults, each on (2, 2) under baseline_rules, one step
FAULTS = ("lerp_no_model_sum", "ln_x_scale_no_model_sum",
          "gate_combine_identity_backward")
SERVE = {m: (m, ()) for m in MESHES}
SERVE["guard-1x4"] = ("1x4", GUARD)
PARTS = ("pos0.tm", "pos0.cm")
#: the guard's time-mix leaves the rules split over ``model`` (its
#: columns and ``wo``'s rows; 3 heads leave ``u`` whole), gathered once a
#: call: names as ``_torch_dist_worker._rwkv_shapes`` gives them (the
#: channel-mix's ``wr`` shares the time-mix's column shards' shape)
GUARD_GATHERS = ["cm.wr/tm.wg/tm.wk/tm.wr/tm.wv"] * 4 + ["tm.wo"]


@functools.lru_cache(maxsize=None)
def _pair(over=()):
    jcfg = jax_get_config(ARCH + "-smoke").replace(dtype="float32",
                                                    **dict(over))
    tcfg = get_config(ARCH + "-smoke").replace(dtype="float32", **dict(over))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _batches(over=()):
    jcfg, tcfg, _, _ = _pair(over)
    out = []
    for seed in SEEDS:
        jb = JD.synthetic_batch_for(jcfg, JShapeSpec("t", S, B, "train"),
                                    seed=seed)
        tb = TD.synthetic_batch_for(tcfg, ShapeSpec("t", S, B, "train"),
                                    seed=seed, device="cpu")
        out.append((jb, {k: v.numpy() for k, v in tb.items()}))
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(over=()):
    """The JAX package's two steps on the global batches, each as
    {"start", "end": the states before and after it (numpy), "grads": its
    gradient leaves from the first moments, "metrics"}."""
    jcfg, _, jp, _ = _pair(over)
    step = JS.make_train_step(jcfg)
    b1 = JO.AdamWConfig().b1
    params, state, out = jp, JO.init_state(jp), []
    for b, _ in _batches(over):
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
def _serve_inputs(over=()):
    _, tcfg, _, _ = _pair(over)
    inputs = TD.synthetic_batch_for(tcfg, ShapeSpec("p", S, 4, "prefill"),
                                    seed=9, device="cpu")
    rng = np.random.default_rng(10)
    state = tree_map(lambda t: t.numpy(),
                     TM.init_decode_state(tcfg, 4, CACHE, device="cpu"))
    state["caches"] = tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        state["caches"])
    state["lengths"] = np.asarray(LENGTHS, np.int32)
    return {"inputs": {k: v.numpy() for k, v in inputs.items()},
            "state": state, "cache": CACHE,
            "next": rng.integers(0, tcfg.vocab_size, (4, 1)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_serve(over=()):
    """The JAX package's prefill on the serve inputs and its decode step
    on the random state: (prefill logits, prefill caches' leaves, decode
    logits, decode caches' leaves, lengths), numpy."""
    jcfg, _, jp, _ = _pair(over)
    ins = _serve_inputs(over)
    logits, state = JS.make_prefill_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in ins["inputs"].items()})
    dstate = jax.tree_util.tree_map(jnp.asarray, ins["state"])
    dlogits, new = JS.make_decode_step(jcfg)(
        jp, dstate, {"tokens": jnp.asarray(ins["next"])})
    leaves = lambda t: [np.asarray(x) for x in  # noqa: E731
                        jax.tree_util.tree_leaves(t)]
    return (np.asarray(logits), leaves(state["caches"]),
            np.asarray(dlogits), leaves(new["caches"]),
            np.asarray(new["lengths"]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def train_case(m, rules, over, steps=2, **kw):
        return dict(arch=ARCH + "-smoke", mesh=MESHES[m], rules=rules,
                    microbatches=1, cfg=dict(over), watch="rwkv",
                    starts=[s["start"] for s in _jax_steps(over)][:steps],
                    batches=[b for _, b in _batches(over)][:steps], **kw)
    train = [train_case(*v) for v in TRAIN.values()]
    train += [train_case("2x2", "baseline_rules", (), steps=1, fault=f)
              for f in FAULTS]
    serve = [dict(arch=ARCH + "-smoke", mesh=MESHES[m], rules="serve_rules",
                  cfg=dict(over), params=_pair(over)[3], watch="rwkv",
                  **_serve_inputs(over))
             for m, over in SERVE.values()]
    out = run_world(tensor_parallel_world, 4,
                    tmp_path_factory.mktemp("rwkv"), train, serve,
                    timeout=900)
    labels = list(TRAIN) + list(FAULTS)
    return ([dict(zip(labels, r["train"])) for r in out],
            [dict(zip(SERVE, r["serve"])) for r in out])


def _adam_u(state, step: int, cfg) -> list:
    """AdamW's step direction m^ / (sqrt(v^) + eps) at step ``step`` from a
    state's moments, every leaf in float64."""
    b1c, b2c = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    return [np.asarray(m, np.float64) / b1c
            / (np.sqrt(np.asarray(v, np.float64) / b2c) + cfg.eps)
            for m, v in zip(jax.tree_util.tree_leaves(state["mu"]),
                            jax.tree_util.tree_leaves(state["nu"]))]


def _check_step(got, want, opt):
    """One cell step against the JAX package's: loss, grad norm, params
    and moments at ``test_torch_sharded_train.py``'s pins. A param may
    leave ``PARAM_ATOL`` (at most ``ROUND_FLIPS`` elements a step, each
    within 2 lr) only where AdamW's step is ill-conditioned: its reference
    gradient within ``ROUND_ZERO`` of its leaf's max
    (``test_torch_tensor_parallel.py``'s rule), or the step direction of
    each side's own moments differing by what the excess needs (|g| near
    eps, where m / (sqrt(v) + eps) turns on the gradient's rounding: a
    wo element of rwkv6-7b-smoke read |g| 4.9e-9 against its leaf's max
    1.4e-3 and the port's 3.4e-9, 2.35e-5 off)."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               want["metrics"]["grad_norm"], rtol=NORM_RTOL)
    t = want["start"]["step"] + 1
    du = [np.abs(a - b) for a, b in zip(_adam_u(got, t, opt),
                                        _adam_u(want["end"], t, opt))]
    past = 0
    for w, g, gr, d in zip(jax.tree_util.tree_leaves(want["end"]["params"]),
                           tree_leaves(got["params"]), want["grads"], du):
        diff = np.abs(g - np.asarray(w, np.float64))
        near = (np.abs(gr) <= ROUND_ZERO * np.abs(gr).max()) \
            | (diff <= PARAM_ATOL + opt.lr * d)
        far = diff > PARAM_ATOL
        past += int(far.sum())
        assert not (far & ~near).any(), diff.max()
        assert (diff <= PARAM_ATOL + 2 * opt.lr).all()
    assert past <= ROUND_FLIPS, past
    for name in ("mu", "nu"):
        for w, g in zip(jax.tree_util.tree_leaves(want["end"][name]),
                        tree_leaves(got[name])):
            _close_rel(g, w, MOMENT_TOL)


@pytest.mark.parametrize("label", list(TRAIN))
def test_train_cell_matches_jax(world, label):
    """Each of two steps, from the JAX package's state before it: loss,
    grad norm, params and AdamW moments against its ``make_train_step``
    on the global batch."""
    over = TRAIN[label][2]
    res = world[0][0][label]
    assert len(res["steps"]) == 2
    for i, (got, want) in enumerate(zip(res["steps"], _jax_steps(over))):
        assert got["step"] == i + 1 and got["placements_kept"]
        _check_step(got, want, JO.AdamWConfig())


@pytest.mark.parametrize("label", list(TRAIN))
def test_cell_records_its_rwkv_layout(world, label):
    """The train cell names its split parts (``Cell.rwkv_split``), or,
    where a rank's columns cut a WKV head, the time-mix's guard, its
    channel-mix still split."""
    res = world[0][0][label]
    if TRAIN[label][2] == GUARD:
        assert res["guarded"] == ("pos0.tm",)
        assert res["rwkv_split"] == ("pos0.cm",)
    else:
        assert res["guarded"] == ()
        assert res["rwkv_split"] == PARTS
    assert res["mamba_split"] == () and res["in_proj_route"] == ""


def _moment(state, part, name):
    return np.asarray(state["mu"]["blocks"]["pos0"][part][name])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_caught(world, fault):
    """Each planted fault fails the comparison with the JAX package, and
    the leaf it corrupts is off by more than ``MOMENT_TOL``: ``lora_A``
    and ``ln_x_scale`` left unsummed keep each rank's part of their
    gradient (its heads' channels); the gate combine's identity backward
    gives each rank's partial ``kv`` only its own columns' gradient, so
    the channel-mix's ``wv`` rows miss the others'."""
    got = world[0][0][fault]["steps"][0]
    want = _jax_steps()[0]
    with pytest.raises(AssertionError):
        _check_step(got, want, JO.AdamWConfig())
    part, leaf = {"lerp_no_model_sum": ("tm", "lora_A"),
                  "ln_x_scale_no_model_sum": ("tm", "ln_x_scale"),
                  "gate_combine_identity_backward": ("cm", "wv")}[fault]
    with pytest.raises(AssertionError):
        _close_rel(_moment(got, part, leaf),
                   _moment(want["end"], part, leaf), MOMENT_TOL)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_match_jax(world, label):
    """The prefill cell's last-token logits and states (``x_tm``, ``x_cm``
    and ``wkv``, the last on a rank's heads), and a decode step's logits
    and state, gathered whole, against the JAX package's
    ``make_prefill_step`` and ``make_decode_step`` on the same inputs."""
    over = SERVE[label][1]
    got = world[1][0][label]
    logits, caches, dlogits, dcaches, lengths = _jax_serve(over)
    tol = dict(rtol=0, atol=SERVE_ATOL)
    np.testing.assert_allclose(got["prefill_logits"], logits, **tol)
    assert got["prefill_placements"][-1] == "S(1)"      # vocab on model
    got_caches = tree_leaves(got["prefill_state"]["caches"])
    assert len(got_caches) == len(caches) == 3 * 1
    for w, g in zip(caches, got_caches):
        np.testing.assert_allclose(g, w, **tol)
    for dist_decode, dec in got["decode"].items():
        np.testing.assert_allclose(dec["logits"], dlogits, **tol)
        for w, g in zip(dcaches, tree_leaves(dec["state"]["caches"])):
            np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_array_equal(dec["state"]["lengths"], lengths)
        assert dec["placements_kept"], dist_decode
    assert got["rwkv_split"] == (("pos0.cm",) if over else PARTS)


CASES = [f"train:{k}" for k in TRAIN] + [f"serve:{k}" for k in SERVE]


def _calls(world, label):
    """(config overrides, every rank's recorded calls of a case as (what,
    tally, account, the RWKV6 leaves gathered over ``model``))."""
    kind, key = label.split(":", 1)
    calls = []
    if kind == "train":
        for rank in world[0]:
            res = rank[key]
            calls += [(f"train step {i}", s["tally"], res["account"],
                       s["model_gathers"])
                      for i, s in enumerate(res["steps"])]
        return TRAIN[key][2], calls
    for rank in world[1]:
        res = rank[key]
        p = res["prefill"]
        calls.append(("prefill", p["tally"], p["account"],
                      p["model_gathers"]))
        for d, dec in res["decode"].items():
            calls.append((f"decode dist={d}", dec["tally"], dec["account"],
                          dec["model_gathers"]))
    return SERVE[key][1], calls


@pytest.mark.parametrize("label", CASES)
def test_rwkv_weights_over_model(world, label):
    """No call all-gathers an RWKV6 weight over ``model``, but the guard's
    time-mix, whose column shards and ``wo`` rows are gathered once a
    call. No call reaches DTensor's own collectives."""
    over, calls = _calls(world, label)
    for what, tally, _, gathered in calls:
        assert not [k for k in tally if k.startswith("functional:")], what
        if over == GUARD:
            assert sorted(gathered) == sorted(GUARD_GATHERS), (what,
                                                              gathered)
        else:
            assert not gathered, (what, gathered)


@pytest.mark.parametrize("label", CASES)
def test_collectives_match_the_dry_run(world, label):
    """Each rank's collectives a call (count and ring wire bytes, by
    kind) equal ``dryrun.account``'s for the same cell."""
    for what, tally, account, _ in _calls(world, label)[1]:
        assert set(tally) == set(account), (what, tally, account)
        for kind, (n, wire) in account.items():
            assert tally[kind][0] == n, (what, kind, tally[kind], n)
            assert tally[kind][1] == pytest.approx(wire, rel=WIRE_RTOL,
                                                   abs=1e-6), (what, kind)


@pytest.mark.parametrize("mesh,rules,kind,heads", [
    ((16, 16), "baseline_rules", "train_4k", 4),
    ((16, 16), "sp_rules", "train_4k", 4),
    ((16, 16), "serve_rules", "prefill_32k", 4),
    ((16, 16), "serve_rules", "decode_32k", 4),
    ((1, 2), "baseline_rules", "train_4k", 32),
    ((16, 1), "baseline_rules", "train_4k", 64)])
def test_rwkv6_cells_split_their_parts(mesh, rules, kind, heads):
    """rwkv6-7b's cells: the time-mix on ``heads`` WKV heads a rank and the
    channel-mix on its columns, no RWKV6 leaf gathered over ``model``, the
    gradients of exactly ``RWKV_PARTIAL``'s leaves (and, under sequence
    parallelism, every leaf whole on ``model``) summed there, the split
    leaves' never; on a model axis of one nothing splits."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.cells import (RWKV_PARTIAL, build_cell,
                                          leaf_plans)
    from repro_torch.launch.mesh import MeshShape
    m = MeshShape(mesh, ("data", "model"))
    r = getattr(SH, rules)(False)
    cell = build_cell(ARCH, kind, m, rules=r)
    cfg = cell.cfg
    assert cell.guarded == ()
    if mesh[1] == 1:
        assert cell.rwkv_split == ()
        return
    assert cell.rwkv_split == PARTS
    assert cfg.rwkv_heads // mesh[1] == heads
    seq = rules == "sp_rules"
    split = {"tm": ("wr", "wk", "wv", "wg", "wo", "u"),
             "cm": ("wk", "wv", "wr")}
    for plan in leaf_plans(cfg, m, r, seq=seq,
                           decode=kind.startswith("decode")):
        if plan.path[0] != "blocks" or plan.path[2] not in ("tm", "cm"):
            continue
        part, leaf = plan.path[2:]
        assert 1 not in plan.upfront, plan.path
        if leaf in split[part]:
            assert 1 not in plan.fsdp and not plan.model_sum, plan.path
        else:
            assert plan.model_sum == (seq or leaf in RWKV_PARTIAL), \
                plan.path


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


def test_rwkv6_world_of_two_rehearsed(smoke):
    """chip_smoke's phase 20 at smoke size on the CPU: the train step,
    prefill and decode cells on a (1, 2) mesh against the world of one at
    the pins, each rank's collectives equal to the dry run's, no RWKV6
    weight gathered over ``model``, and the scan launches a rank (the
    phase checks itself)."""
    out = smoke.rwkv_world_phase("cpu", arch="rwkv6-7b-smoke", layers=2,
                                 batch=2, seq=16, cache=16)
    assert set(out["calls"]) == {"train", "prefill", "decode dist=False",
                                 "decode dist=True"}
    launches = out["ranks"][0]
    # 2 time-mixes: forward and recompute, one backward; prefill 2
    assert launches["train"]["launches"]["wkv6_scan"] == 4
    assert launches["train"]["launches"]["wkv6_scan_backward"] == 2
    assert launches["prefill"]["launches"]["wkv6_scan"] == 2
    assert max(out["grad_gaps"].values()) <= 1e-4


def test_rwkv6_per_rank_kernels_rehearsed(smoke):
    """chip_smoke's per-rank cases of rwkv6-7b through the plain versions
    on the CPU, at smoke shapes: the WKV scan forward and backward at one
    rank's heads."""
    out = smoke.tp_wkv_phase("cpu", cases=[("rwkv6 train_4k tp16", 2, 64,
                                            4, 16, True)], time_it=False)
    for name in ("wkv6_scan", "wkv6_scan_backward"):
        (rec,) = out[name]
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name
        assert rec["H"] == 4 and rec["S"] == 64
