"""The port's MoE cells computing on their expert shards
(``arch/moe.py``'s expert-parallel form through ``launch.cells``) in one
gloo world of 4 processes.

Cases: the two MoE smoke configs (E 4, d_ff 128), dbrx-132b-smoke (k 2)
and llama4-maverick-400b-a17b-smoke (k 1, a shared expert, an ``attn``
block before each MoE block), each on a (2, 2) and a (1, 4) ("data",
"model") mesh: the experts split over ``model`` (EP), 2 or 1 a rank. Two
train steps of 8 x 16 tokens under ``baseline_rules`` and ``sp_rules``,
each from the JAX package's state before it, against the JAX package's
``make_train_step`` on the global batch (``moe_groups`` 4, the mesh's
size, as the cell's) at ``test_torch_sharded_train.py``'s pins; prefill
and decode cells (with and without the distributed flash-decode) under
``serve_rules`` (the experts over ``model``, their columns over ``data``:
the expert buffer's groups gathered over ``data`` and its products
reduce-scattered back) against the port's unsharded calls. Derived
cases: E 6 on (1, 4), which does not divide the model extent, so each
rank holds every expert's ``d_ff / 4`` columns (``expert_mlp@model``);
single blocks at capacity factor 0.25, whose dropped choices must be the
unsharded block's; and a planted fault, the router's gradient summed over
``model`` (``model_sum``), which the pins must catch.

Every call's collectives are recorded (``_torch_dist_worker.
CollectiveLog``): no rank all-gathers an expert weight over ``model``,
none reaches DTensor's own collectives, and each rank's count of
collectives and their ring wire bytes equal ``launch.dryrun.account``'s
for the same cell. The last test rehearses ``chip_smoke.py``'s phase 18
at smoke size."""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import expert_parallel_world, run_world
from repro.arch import model as JM
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_config as jax_get_config
from repro.data import synthetic as JD
from repro.train import optim as JO
from repro.train import step as JS
from repro_torch.arch import model as TM
from repro_torch.arch import moe as TMoE
from repro_torch.arch.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import synthetic as TD
from repro_torch.train import step as TS
from test_torch_sharded_train import (LOSS_RTOL, MOMENT_TOL, NORM_RTOL,
                                      PARAM_ATOL)
from test_torch_tensor_parallel import (CACHE, LENGTHS, ROUND_FLIPS,
                                        ROUND_ZERO, SERVE_ATOL, WIRE_RTOL)

torch.set_num_threads(1)

ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
E6 = (("num_experts", 6),)
B, S = 8, 16
SEEDS = (31, 32)
# the cells' MoE token groups: the mesh's size over the global batch
GROUPS = 4
# single blocks at a capacity factor low enough that choices drop
DROP_CF = 0.25
DROP = {f"drop-{m}": MESHES[m] for m in MESHES}
DROP["drop-E6-1x4"] = MESHES["1x4"]
# the dense path (every expert on every token) on the same shards
DROP.update({f"dense-{m}": MESHES[m] for m in MESHES})

TRAIN = {f"{a.split('-')[0]}-{m}-{r.split('_')[0]}": (a, m, r, ())
         for a in ARCHS for m in MESHES for r in ("baseline_rules",
                                                   "sp_rules")}
TRAIN.update({"E6-1x4-baseline": ("dbrx-132b", "1x4", "baseline_rules", E6),
              "E6-1x4-sp": ("dbrx-132b", "1x4", "sp_rules", E6),
              # the 2D expert shards in training: the columns' gradients,
              # taken over every data rank's rows, are not reduced there
              "dbrx-2x2-serve": ("dbrx-132b", "2x2", "serve_rules", ())})
FAULT = "fault-router-model-sum"
SERVE = {f"{a.split('-')[0]}-{m}": (a, m, ()) for a in ARCHS
         for m in MESHES}
SERVE["E6-1x4"] = ("dbrx-132b", "1x4", E6)


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
        out.append((jb, {k: v.numpy() for k, v in tb.items()}))
    return out


def _np_state(params, state) -> dict:
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "mu": as_np(state.mu),
            "nu": as_np(state.nu), "step": int(state.step)}


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, over=()):
    """The JAX package's two steps on the global batches (its MoE groups
    the cell's), each as {"start", "end": the states before and after it
    (numpy), "grads": its gradient leaves from the first moments,
    "metrics"}."""
    jcfg, _, jp, _ = _pair(arch, over)
    step = JS.make_train_step(jcfg, moe_groups=GROUPS)
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
def _block_inputs(label):
    """A MoE block's params (the first period's, from the JAX package's
    draw), an input, an output gradient and the token groups."""
    over = E6 if "E6" in label else ()
    _, tcfg, _, np_p = _pair("dbrx-132b", over)
    p = {k: np.ascontiguousarray(v[0])
         for k, v in np_p["blocks"]["pos0"]["moe"].items()}
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 16, tcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    return dict(arch="dbrx-132b-smoke", cfg=dict(over), params=p, x=x,
                dy=dy, cf=DROP_CF, groups=2,
                path="dense" if label.startswith("dense") else "dispatch")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def train_case(arch, m, rules, over, **kw):
        return dict(arch=arch + "-smoke", mesh=MESHES[m], rules=rules,
                    microbatches=1, cfg=dict(over), watch="experts",
                    starts=[s["start"] for s in _jax_steps(arch, over)],
                    batches=[b for _, b in _batches(arch, over)], **kw)
    train = [train_case(*v) for v in TRAIN.values()]
    train.append(train_case("dbrx-132b", "2x2", "baseline_rules", (),
                            fault="router_model_sum"))
    serve = [dict(arch=arch + "-smoke", mesh=MESHES[m], rules="serve_rules",
                  cfg=dict(over), params=_pair(arch, over)[3],
                  watch="experts", **_serve_inputs(arch, over))
             for arch, m, over in SERVE.values()]
    blocks = [dict(mesh=mesh, **_block_inputs(label))
              for label, mesh in DROP.items()]
    out = run_world(expert_parallel_world, 4,
                    tmp_path_factory.mktemp("ep"), train, serve, blocks,
                    timeout=900)
    labels = list(TRAIN) + [FAULT]
    return ([dict(zip(labels, r["train"])) for r in out],
            [dict(zip(SERVE, r["serve"])) for r in out],
            [dict(zip(DROP, r["blocks"])) for r in out])


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
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(got["metrics"][key],
                                   want["metrics"][key], rtol=LOSS_RTOL)
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
    grad norm, aux losses, params and AdamW moments against its
    ``make_train_step`` on the global batch."""
    arch, _, _, over = TRAIN[label]
    lr = JO.AdamWConfig().lr
    for i, (got, want) in enumerate(zip(world[0][0][label]["steps"],
                                        _jax_steps(arch, over))):
        assert got["step"] == i + 1 and got["placements_kept"]
        _check_step(got, want, lr)


def test_router_model_sum_is_caught(world):
    """The planted fault (the router's gradient, whole on every rank,
    summed over the model extent of 2) fails the comparison with the JAX
    package: the grad norm past ``NORM_RTOL``, and the router's first
    moment, the step's clipped gradient, twice the reference's times the
    ratio of the two clip scales."""
    got = world[0][0][FAULT]["steps"][0]
    want = _jax_steps("dbrx-132b")[0]
    norms = got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]
    rel = abs(norms[0] - norms[1]) / norms[1]
    assert rel > NORM_RTOL, rel
    with pytest.raises(AssertionError):
        _check_step(got, want, JO.AdamWConfig().lr)
    clip = JO.AdamWConfig().grad_clip
    fault, ref = (min(1.0, clip / (n + 1e-9)) for n in norms)
    g = np.asarray(got["mu"]["blocks"]["pos0"]["moe"]["router"])
    w = np.asarray(want["end"]["mu"]["blocks"]["pos0"]["moe"]["router"])
    _close_rel(g, 2 * fault / ref * w, MOMENT_TOL)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_match_unsharded(world, label):
    """The prefill cell's last-token logits and caches, and a decode
    step's logits and state, with and without the distributed
    flash-decode, gathered whole, against the port's unsharded calls on
    the same inputs with the cells' token groups."""
    arch, _, over = SERVE[label]
    got = world[1][0][label]
    _, tcfg, _, np_p = _pair(arch, over)
    ins = _serve_inputs(arch, over)
    params = params_from_numpy(np_p, "cpu")
    tol = dict(rtol=0, atol=SERVE_ATOL)
    with torch.no_grad():
        logits, pstate = TS.make_prefill_step(tcfg, moe_groups=GROUPS)(
            params, {k: torch.from_numpy(v) for k, v in ins["inputs"].items()})
    np.testing.assert_allclose(got["prefill_logits"], logits.numpy(), **tol)
    for w, g in zip(tree_leaves(pstate["caches"]),
                    tree_leaves(got["prefill_state"]["caches"])):
        np.testing.assert_allclose(g, w.numpy(), **tol)
    for dist_decode, dec in got["decode"].items():
        state = tree_map(torch.from_numpy, ins["state"])
        with torch.no_grad():
            want, new = TS.make_decode_step(tcfg, moe_groups=GROUPS)(
                params, state, {"tokens": torch.from_numpy(ins["next"])})
        np.testing.assert_allclose(dec["logits"], want.numpy(), **tol)
        for w, g in zip(tree_leaves(new["caches"]),
                        tree_leaves(dec["state"]["caches"])):
            np.testing.assert_allclose(g, w.numpy(), **tol)
        assert dec["placements_kept"], dist_decode


@pytest.mark.parametrize("label", list(DROP))
def test_dropping_block_matches_unsharded(world, label):
    """A block at capacity factor 0.25 on each rank's expert shards: the
    same slots and dropped choices as the unsharded block (some drop),
    and its output, aux losses and gradients (of ``x``, the router, and
    each rank's expert shards) equal to the unsharded block's; the dense
    path's likewise (no slots)."""
    c = _block_inputs(label)
    _, tcfg, _, _ = _pair("dbrx-132b", E6 if "E6" in label else ())
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in c["params"].items()}
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    dense = c["path"] == "dense"
    if dense:
        out, aux = TMoE.moe_block_dense(tcfg, p, x)
    else:
        out, aux = TMoE.moe_block_dispatch(tcfg, p, x, groups=c["groups"],
                                           capacity_factor=DROP_CF)
    (torch.sum(out * torch.from_numpy(c["dy"])) + 0.01 * aux["moe_lb_loss"]
     + 1e-3 * aux["moe_z_loss"]).backward()
    G, Sg, C = TMoE.dispatch_geometry(tcfg, x.shape[0] * x.shape[1], DROP_CF,
                                      c["groups"])
    with torch.no_grad():
        want_slot = TMoE.dispatch_slots(
            TMoE._router(tcfg, p, x)[1].reshape(G, Sg, -1),
            tcfg.num_experts)
    assert dense or int((want_slot >= C).sum()) > 0     # choices drop
    tol = dict(rtol=0, atol=SERVE_ATOL)
    for rank in world[2]:
        got = rank[label]
        if dense:
            assert got["slots"] == []
        else:
            assert got["capacity"] == C
            (slot,) = got["slots"]
            np.testing.assert_array_equal(slot, want_slot.numpy())
        np.testing.assert_allclose(got["out"], out.detach().numpy(), **tol)
        np.testing.assert_allclose(got["dx"], x.grad.numpy(), **tol)
        for k in aux:
            assert got["aux"][k] == pytest.approx(float(aux[k].detach()),
                                                  rel=1e-6)
        r, n = got["rank"], got["n"]
        for k, g in got["grads"].items():
            want = p[k].grad.numpy()
            if k != "router":
                if tcfg.num_experts % n == 0:
                    el = tcfg.num_experts // n
                    want = want[r * el:(r + 1) * el]
                else:
                    f = tcfg.d_ff // n
                    want = want[:, r * f:(r + 1) * f] if k == "w_down" \
                        else want[..., r * f:(r + 1) * f]
            np.testing.assert_allclose(g, want, **tol)


CASES = [f"train:{k}" for k in TRAIN] + [f"serve:{k}" for k in SERVE]


def _calls(world, label):
    """Every rank's recorded calls of a case as (what, tally, account,
    expert gathers over ``model``)."""
    kind, key = label.split(":", 1)
    calls = []
    if kind == "train":
        for rank in world[0]:
            res = rank[key]
            calls += [(f"train step {i}", s["tally"], res["account"],
                       s["model_gathers"])
                      for i, s in enumerate(res["steps"])]
        return calls
    for rank in world[1]:
        res = rank[key]
        p = res["prefill"]
        calls.append(("prefill", p["tally"], p["account"],
                      p["model_gathers"]))
        for d, dec in res["decode"].items():
            calls.append((f"decode dist={d}", dec["tally"], dec["account"],
                          dec["model_gathers"]))
    return calls


@pytest.mark.parametrize("label", CASES)
def test_no_expert_gathered_over_model(world, label):
    """No rank all-gathers an expert weight (``w_gate``, ``w_up``,
    ``w_down``: its block or a period's slice) over ``model``, and none
    reaches DTensor's own collectives."""
    for what, tally, _, gathers in _calls(world, label):
        assert not [k for k in tally if k.startswith("functional:")], what
        assert not gathers, (what, gathers)
        assert "all_to_all" not in tally and "all_to_all_single" not in \
            tally, what


@pytest.mark.parametrize("label", CASES)
def test_collectives_match_the_dry_run(world, label):
    """Each rank's collectives a call (count and ring wire bytes, by
    kind) equal ``dryrun.account``'s for the same cell."""
    for what, tally, account, _ in _calls(world, label):
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


def test_moe_world_of_two_rehearsed(smoke):
    """chip_smoke's phase 18 at smoke size on the CPU: every collective
    taken, the gradients and the serve cells against the world of one at
    the pins, each rank's collectives equal to the dry run's and the
    launches the phase expects (the phase checks itself)."""
    out = smoke.ep_world_phase("cpu", arch="dbrx-132b-smoke", layers=2,
                               batch=2, seq=16, cache=16)
    assert set(out["calls"]) == {
        "train", "prefill 1x2", "prefill 2x1",
        *(f"decode {m} dist={d}" for m in ("1x2", "2x1")
          for d in (False, True))}
    launches = out["ranks"][0]
    assert launches["train"]["launches"]["flash_attention"] == 4
    assert launches["train"]["launches"]["flash_attention_backward"] == 2
    assert max(out["grad_gaps"].values()) <= 1e-4


def test_dbrx_per_rank_kernels_rehearsed(smoke):
    """chip_smoke's per-rank attention case of dbrx-132b on a model axis
    of 2 (H 24, KV 4: G 6) through the plain versions on the CPU."""
    (case,) = [h for h in smoke.TP_HEADS if h[0] == "dbrx tp2"]
    out = smoke.tp_kernel_phase("cpu", heads=[case], time_it=False)
    for name in ("flash_attention", "flash_attention_backward",
                 "decode_attention"):
        (rec,) = out[name]
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name


@pytest.mark.parametrize("arch,rules,want", [
    ("dbrx-132b", "baseline_rules", ("pos0",)),
    ("dbrx-132b", "serve_rules", ("pos0",)),
    ("llama4-maverick-400b-a17b", "baseline_rules", ("pos1",)),
    ("qwen3-1.7b", "baseline_rules", ())])
def test_cell_records_its_expert_split(arch, rules, want):
    """``Cell.expert_split`` names the MoE blocks that compute on expert
    shards on the (16, 16) pod mesh; a (16, 1) mesh under the baseline
    rules splits no expert dim, and its MoE blocks compute whole."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import MeshShape
    pod = MeshShape((16, 16), ("data", "model"))
    kind = "prefill_32k" if rules == "serve_rules" else "train_4k"
    assert build_cell(arch, kind, pod, rules=getattr(S, rules)(False)) \
        .expert_split == want
    flat = MeshShape((16, 1), ("data", "model"))
    assert build_cell(arch, "train_4k", flat).expert_split == ()
