"""zamba2's cells computing on their shards (``arch/mamba2.py``'s mixer on
its SSD heads and Zamba2's shared block on its heads and MLP columns,
through ``launch.cells``) in one gloo world of 4 processes.

Cases: zamba2-2.7b-smoke (d 64, 8 SSD heads of P 16, N 16, a fused
``in_proj`` of 296 columns, so its uniform split over ``model`` straddles
``[z, x, B, C, dt]``; the shared block's attention H 4, KV 2) on a (2, 2)
and a (1, 4) ("data", "model") mesh: 4 or 2 SSD heads a rank. Two train
steps of 8 x 16 tokens under ``baseline_rules`` and ``sp_rules``, each
from the JAX package's state before it, against the JAX package's
``make_train_step`` on the global batch at ``test_torch_sharded_train.py``'s
pins; prefill and decode cells (with and without the distributed
flash-decode) under ``serve_rules`` against the JAX package's
``make_prefill_step`` and ``make_decode_step`` at ``SERVE_ATOL``. A guard
case, d_model 48 (6 SSD heads) on (1, 4): its mixers' leaves are gathered
over ``model`` and computed replicated (``Cell.guarded``), the shared
block still on its shards. Three planted faults the pins must catch: the
norm's sum of squares with an identity backward (``TPContext.reduce`` in
place of ``TPContext.total``), ``conv_w``'s gradient not summed over
``model``, and the shared block's ``wk``'s not summed.

Every call's collectives are recorded (``_torch_dist_worker.
CollectiveLog``): a decode cell all-gathers no Mamba2 weight over
``model`` (``conv_w`` and ``conv_b``, gathered once a call in every cell,
aside), a train or prefill cell only ``in_proj`` (its period's gather);
none reaches DTensor's own collectives; each rank's count of collectives
and their ring wire bytes equal ``launch.dryrun.account``'s. The last
tests rehearse ``chip_smoke.py``'s phase 19 and its per-rank kernel cases
at smoke size."""
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
from test_torch_sharded_train import (LOSS_RTOL, MOMENT_TOL, NORM_RTOL,
                                      PARAM_ATOL)
from test_torch_tensor_parallel import (CACHE, LENGTHS, ROUND_FLIPS,
                                        ROUND_ZERO, SERVE_ATOL, WIRE_RTOL)

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# 6 SSD heads (d_inner 96 of P 16) on a model extent of 4: the guard
GUARD = (("d_model", 48),)
B, S = 8, 16
SEEDS = (31, 32)

TRAIN = {f"{m}-{r.split('_')[0]}": (m, r, ())
         for m in MESHES for r in ("baseline_rules", "sp_rules")}
TRAIN.update({"guard-1x4-baseline": ("1x4", "baseline_rules", GUARD),
              "guard-1x4-sp": ("1x4", "sp_rules", GUARD)})
# the planted faults, each on (2, 2) under baseline_rules, one step
FAULTS = ("norm_sum_identity_backward", "conv_w_no_model_sum",
          "shared_wk_no_model_sum")
SERVE = {m: (m, ()) for m in MESHES}
SERVE["guard-1x4"] = ("1x4", GUARD)


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


def _np_state(params, state) -> dict:
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "mu": as_np(state.mu),
            "nu": as_np(state.nu), "step": int(state.step)}


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
                                    seed=7, device="cpu")
    rng = np.random.default_rng(8)
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
    logits, decode caches' leaves), numpy."""
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
                    microbatches=1, cfg=dict(over), watch="mamba",
                    starts=[s["start"] for s in _jax_steps(over)][:steps],
                    batches=[b for _, b in _batches(over)][:steps], **kw)
    train = [train_case(*v) for v in TRAIN.values()]
    train += [train_case("2x2", "baseline_rules", (), steps=1, fault=f)
              for f in FAULTS]
    serve = [dict(arch=ARCH + "-smoke", mesh=MESHES[m], rules="serve_rules",
                  cfg=dict(over), params=_pair(over)[3], watch="mamba",
                  **_serve_inputs(over))
             for m, over in SERVE.values()]
    out = run_world(tensor_parallel_world, 4,
                    tmp_path_factory.mktemp("mamba"), train, serve,
                    timeout=900)
    labels = list(TRAIN) + list(FAULTS)
    return ([dict(zip(labels, r["train"])) for r in out],
            [dict(zip(SERVE, r["serve"])) for r in out])


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= tol, err


def _check_step(got, want, lr):
    """One cell step against the JAX package's: loss, grad norm, params
    (with ``test_torch_tensor_parallel.py``'s rule for elements whose
    gradient is within rounding of zero) and moments."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               want["metrics"]["grad_norm"], rtol=NORM_RTOL)
    past = 0
    for w, g, gr in zip(jax.tree_util.tree_leaves(want["end"]["params"]),
                        tree_leaves(got["params"]), want["grads"]):
        diff = np.abs(g - np.asarray(w, np.float64))
        near = np.abs(gr) <= ROUND_ZERO * np.abs(gr).max()
        far = diff > PARAM_ATOL
        past += int(far.sum())
        assert not (far & ~near).any(), diff.max()
        assert (diff <= PARAM_ATOL + 2 * lr).all()
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
    lr = JO.AdamWConfig().lr
    res = world[0][0][label]
    assert len(res["steps"]) == 2
    for i, (got, want) in enumerate(zip(res["steps"], _jax_steps(over))):
        assert got["step"] == i + 1 and got["placements_kept"]
        _check_step(got, want, lr)


@pytest.mark.parametrize("label", list(TRAIN))
def test_cell_records_its_mamba_layout(world, label):
    """The train cell names its split mixers and their ``in_proj`` route
    (the weight gathered), or, where the SSD heads do not divide the
    model extent, the guard."""
    res = world[0][0][label]
    mixers = tuple(f"pos{j}" for j in range(6))
    if TRAIN[label][2] == GUARD:
        assert res["guarded"] == tuple(f"{p}.mixer" for p in mixers)
        assert res["mamba_split"] == () and res["in_proj_route"] == ""
    else:
        assert res["guarded"] == ()
        assert res["mamba_split"] == mixers
        assert res["in_proj_route"] == "weight"


def _mixer_moment(state, name):
    return np.asarray(state["mu"]["blocks"]["pos0"]["mixer"][name])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_caught(world, fault):
    """Each planted fault fails the comparison with the JAX package, and
    the leaf it corrupts is off by more than ``MOMENT_TOL``: the norm's
    identity backward gives each rank's ``in_proj`` z and x columns its
    own part of the norm's gradient; ``conv_w`` left unsummed keeps each
    rank's part of the B and C channels' gradient (and, the cut keeping
    one rank's block, drops the others' x channels); the shared ``wk``
    left unsummed keeps each rank's KV heads' columns."""
    got = world[0][0][fault]["steps"][0]
    want = _jax_steps()[0]
    with pytest.raises(AssertionError):
        _check_step(got, want, JO.AdamWConfig().lr)
    if fault == "shared_wk_no_model_sum":
        g = np.asarray(got["mu"]["shared"]["attn"]["wk"])
        w = np.asarray(want["end"]["mu"]["shared"]["attn"]["wk"])
    else:
        leaf = "in_proj" if fault.startswith("norm") else "conv_w"
        g, w = _mixer_moment(got, leaf), _mixer_moment(want["end"], leaf)
    with pytest.raises(AssertionError):
        _close_rel(g, w, MOMENT_TOL)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_match_jax(world, label):
    """The prefill cell's last-token logits and caches (the shared
    block's k/v, the conv and ssd states), and a decode step's logits and
    state, with and without the distributed flash-decode, gathered whole,
    against the JAX package's ``make_prefill_step`` and
    ``make_decode_step`` on the same inputs."""
    over = SERVE[label][1]
    got = world[1][0][label]
    logits, caches, dlogits, dcaches, lengths = _jax_serve(over)
    tol = dict(rtol=0, atol=SERVE_ATOL)
    np.testing.assert_allclose(got["prefill_logits"], logits, **tol)
    assert got["prefill_placements"][-1] == "S(1)"      # vocab on model
    got_caches = tree_leaves(got["prefill_state"]["caches"])
    assert len(got_caches) == len(caches)
    for w, g in zip(caches, got_caches):
        np.testing.assert_allclose(g, w, **tol)
    for dist_decode, dec in got["decode"].items():
        np.testing.assert_allclose(dec["logits"], dlogits, **tol)
        for w, g in zip(dcaches, tree_leaves(dec["state"]["caches"])):
            np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_array_equal(dec["state"]["lengths"], lengths)
        assert dec["placements_kept"], dist_decode
        assert dec["in_proj_route"] == ("" if over else "activation")
    assert got["in_proj_route"]["prefill"] == ("" if over else "weight")


CASES = [f"train:{k}" for k in TRAIN] + [f"serve:{k}" for k in SERVE]


def _calls(world, label):
    """(config overrides, every rank's recorded calls of a case as (what,
    tally, account, the Mamba2 leaves gathered over ``model``))."""
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
def test_mamba_weights_over_model(world, label):
    """A decode cell all-gathers no Mamba2 weight over ``model``; a train
    or prefill cell only ``in_proj`` (with its period); the guard's
    mixers are gathered whole: the leaves the rules split there (d_inner
    96 divides 4 where 6 heads and ``in_proj``'s 230 columns do not, so
    ``norm_scale`` and ``out_proj``'s rows, mid-head). No call reaches
    DTensor's own collectives."""
    over, calls = _calls(world, label)
    for what, tally, _, gathered in calls:
        assert not [k for k in tally if k.startswith("functional:")], what
        if over == GUARD:
            assert set(gathered) == {"norm_scale", "out_proj"}, what
        elif what.startswith("decode"):
            assert not gathered, (what, gathered)
        else:
            assert set(gathered) == {"in_proj"}, (what, gathered)


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
    ((16, 16), "baseline_rules", "train_4k", 5),
    ((16, 16), "serve_rules", "prefill_32k", 5),
    ((16, 16), "serve_rules", "decode_32k", 5),
    ((1, 2), "baseline_rules", "train_4k", 40),
    ((16, 1), "baseline_rules", "train_4k", 80)])
def test_zamba2_cells_split_their_mixers(mesh, rules, kind, heads):
    """zamba2-2.7b's cells: the mixers on ``heads`` SSD heads a rank, the
    route of ``in_proj`` by the cell's kind, the shared block's heads and
    MLP columns split, every ``in_proj`` column shard straddling the
    fused boundaries; on a model axis of one nothing splits."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.cells import build_cell, leaf_plans
    from repro_torch.launch.mesh import MeshShape
    m = MeshShape(mesh, ("data", "model"))
    r = getattr(SH, rules)(False)
    cell = build_cell(ARCH, kind, m, rules=r)
    cfg = cell.cfg
    assert cell.guarded == ()
    if mesh[1] == 1:
        assert cell.mamba_split == () and cell.in_proj_route == ""
        return
    assert cell.mamba_split == tuple(f"pos{j}" for j in range(6))
    assert cell.in_proj_route == ("activation" if kind.startswith("decode")
                                  else "weight")
    assert cfg.ssm_heads // mesh[1] == heads
    plans = {p.path: p for p in leaf_plans(cfg, m, r,
                                           decode=kind.startswith("decode"))}
    in_proj = plans[("blocks", "pos0", "mixer", "in_proj")]
    assert (1 in in_proj.fsdp) == (not kind.startswith("decode"))
    for leaf in ("conv_w", "conv_b"):
        plan = plans[("blocks", "pos0", "mixer", leaf)]
        assert 1 in plan.upfront and plan.model_sum
    for leaf in ("wk", "wv"):          # each rank's KV heads' columns
        assert plans[("shared", "attn", leaf)].model_sum
    assert not plans[("shared", "attn", "wq")].upfront
    # the straddle: a column shard's edges fall inside z, x and dt's spans
    di, proj = cfg.d_inner, 2 * cfg.d_inner + 2 * cfg.ssm_state \
        + cfg.ssm_heads
    width = proj // mesh[1]
    assert any(0 < di - r * width < width for r in range(mesh[1]))


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


def test_zamba2_world_of_two_rehearsed(smoke):
    """chip_smoke's phase 19 at smoke size on the CPU: the train step,
    prefill and decode cells on a (1, 2) mesh against the world of one at
    the pins, each rank's collectives equal to the dry run's, no Mamba2
    weight gathered over ``model`` in a decode cell, and the scan
    launches a rank (the phase checks itself)."""
    out = smoke.mamba_world_phase("cpu", arch="zamba2-2.7b-smoke",
                                  layers=6, batch=2, seq=16, cache=16)
    assert set(out["calls"]) == {"train", "prefill", "decode dist=False",
                                 "decode dist=True"}
    launches = out["ranks"][0]
    # 6 mixers: forward and recompute, one backward; prefill 6
    assert launches["train"]["launches"]["ssd_scan"] == 12
    assert launches["train"]["launches"]["ssd_scan_backward"] == 6
    assert launches["prefill"]["launches"]["ssd_scan"] == 6
    assert max(out["grad_gaps"].values()) <= 1e-4


def test_zamba2_per_rank_kernels_rehearsed(smoke):
    """chip_smoke's per-rank cases of zamba2-2.7b through the plain
    versions on the CPU, at smoke shapes: the shared block's attention at
    D 80 (H 2 / KV 2), and the SSD scan forward and backward at one rank's
    heads."""
    out = smoke.tp_kernel_phase("cpu", heads=[("zamba2 shared tp16", 2, 2,
                                               80)], time_it=False,
                                shapes=dict(B=1, S=64, Bd=2, Sd=64))
    for name in ("flash_attention", "flash_attention_backward",
                 "decode_attention"):
        (rec,) = out[name]
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name
        assert rec["D"] == 80
    ssd = smoke.tp_ssd_phase("cpu", cases=[("zamba2 train_4k tp16", 2, 128,
                                            5, 64, 64)], time_it=False)
    for name in ("ssd_scan", "ssd_scan_backward"):
        (rec,) = ssd[name]
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name
