"""Attention split in the middle of a head, computing on head slots
(``arch/layers.py``: ``head_range``; ``distributed/sharding.py``:
``TPContext.to_heads`` / ``to_cols``), through ``launch.cells`` in one gloo
world of 4 processes.

Where a rank's ``H hd / tp`` columns of the fused q projection cut a head
(starcoder2-7b's H 36, qwen2-vl-7b's 28 and llama4-maverick's 40 on a
model axis of 16), each rank projects q on its column block, an
all-to-all moves the columns onto head slots of ceil(H / tp) heads (the
last slots short or empty), the rank attends there and a second
all-to-all brings the output back to its block for its rows of ``wo``.

Cases: starcoder2-7b-smoke (layernorm biases, GELU) and qwen2-vl-7b-smoke
(M-RoPE) with H 9, KV 3 on a (2, 2) ("data", "model") mesh (4.5 heads of
columns a rank; slots of 5 and 4 heads, the second over KV heads 1, 2, 2,
2, which the kernel reads repeated) and H 6, KV 2 on (1, 4) (1.5 heads
a rank; slots of 2, 2, 2 and 0 heads: rank 1's spans KV heads 0 and 1,
rank 3 attends with no head). Two train steps of 8 x 16 tokens under
``baseline_rules`` and ``sp_rules``, each from the JAX package's state
before it, against the JAX package's ``make_train_step`` on the global
batch at ``test_torch_sharded_train.py``'s pins (with
``test_torch_rwkv_parallel.py``'s rule for AdamW's ill-conditioned
elements); prefill and decode cells (with and without the distributed
flash-decode) under ``serve_rules`` against the JAX package's
``make_prefill_step`` and ``make_decode_step`` at ``SERVE_ATOL``. Three
planted faults the pins must catch: the slot's first head at rank x
floor(H / tp), ``wk``'s gradient not summed over ``model``, and the
exchange back to the columns summing its gradient over ``model`` where
each rank keeps its own block's.

Every call's collectives are recorded (``_torch_dist_worker.
CollectiveLog``): no call all-gathers an attention leaf over ``model``;
none reaches DTensor's own collectives; each rank's count of collectives
and their wire bytes (an all-to-all's: the bytes the rank receives) equal
``launch.dryrun.account``'s for its model coordinate. The last tests
rehearse ``chip_smoke.py``'s phase 21 (its world of 8 processes) and its
per-rank attention cases at smoke size."""
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
from repro_torch.distributed.sharding import head_slots, slot_splits
from test_torch_mamba_parallel import _close_rel, _np_state
from test_torch_rwkv_parallel import _check_step
from test_torch_sharded_train import MOMENT_TOL
from test_torch_tensor_parallel import CACHE, LENGTHS, SERVE_ATOL, WIRE_RTOL

torch.set_num_threads(1)

ARCHS = ("starcoder2-7b", "qwen2-vl-7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: each mesh's head counts: a rank's columns cut a head on its model axis
MID = {"2x2": (("num_heads", 9), ("num_kv_heads", 3)),
       "1x4": (("num_heads", 6), ("num_kv_heads", 2))}
B, S = 8, 16
SEEDS = (51, 52)

TRAIN = {f"{a}-{m}-{r.split('_')[0]}": (a, m, r)
         for a in ARCHS for m in MESHES for r in ("baseline_rules",
                                                   "sp_rules")}
# the planted faults, each on starcoder2-7b-smoke's (1, 4) case under
# baseline_rules, one step
FAULTS = ("slot_offset_floor", "attn_wk_no_model_sum",
          "slot_exchange_summing_backward")
FAULT_CASE = ("starcoder2-7b", "1x4", "baseline_rules")
SERVE = {f"{a}-{m}": (a, m) for a in ARCHS for m in MESHES}


@functools.lru_cache(maxsize=None)
def _pair(arch, mesh):
    over = dict(MID[mesh])
    jcfg = jax_get_config(arch + "-smoke").replace(dtype="float32", **over)
    tcfg = get_config(arch + "-smoke").replace(dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _batches(arch, mesh):
    jcfg, tcfg, _, _ = _pair(arch, mesh)
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


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, mesh):
    """The JAX package's two steps on the global batches, each as
    {"start", "end": the states before and after it (numpy), "grads": its
    gradient leaves from the first moments, "metrics"}."""
    jcfg, _, jp, _ = _pair(arch, mesh)
    step = JS.make_train_step(jcfg)
    b1 = JO.AdamWConfig().b1
    params, state, out = jp, JO.init_state(jp), []
    for b, _ in _batches(arch, mesh):
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
def _serve_inputs(arch, mesh):
    _, tcfg, _, _ = _pair(arch, mesh)
    inputs = TD.synthetic_batch_for(tcfg, ShapeSpec("p", S, 4, "prefill"),
                                    seed=11, device="cpu")
    rng = np.random.default_rng(12)
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
def _jax_serve(arch, mesh):
    """The JAX package's prefill on the serve inputs and its decode step
    on the random state: (prefill logits, prefill caches' leaves, decode
    logits, decode caches' leaves, lengths), numpy."""
    jcfg, _, jp, _ = _pair(arch, mesh)
    ins = _serve_inputs(arch, mesh)
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
    def train_case(arch, m, rules, steps=2, **kw):
        return dict(arch=arch + "-smoke", mesh=MESHES[m], rules=rules,
                    microbatches=1, cfg=dict(MID[m]),
                    starts=[s["start"] for s in _jax_steps(arch, m)][:steps],
                    batches=[b for _, b in _batches(arch, m)][:steps], **kw)
    train = [train_case(*v) for v in TRAIN.values()]
    train += [train_case(*FAULT_CASE, steps=1, fault=f) for f in FAULTS]
    serve = [dict(arch=arch + "-smoke", mesh=MESHES[m], rules="serve_rules",
                  cfg=dict(MID[m]), params=_pair(arch, m)[3],
                  **_serve_inputs(arch, m))
             for arch, m in SERVE.values()]
    out = run_world(tensor_parallel_world, 4,
                    tmp_path_factory.mktemp("midhead"), train, serve,
                    timeout=900)
    labels = list(TRAIN) + list(FAULTS)
    return ([dict(zip(labels, r["train"])) for r in out],
            [dict(zip(SERVE, r["serve"])) for r in out])


@pytest.mark.parametrize("mesh,slots,kv", [
    ("2x2", [(0, 5), (5, 4)], [(0, 2), (1, 3)]),
    ("1x4", [(0, 2), (2, 2), (4, 2), (6, 0)],
     [(0, 1), (0, 2), (1, 2), (0, 0)])])
def test_head_slots_of_the_cases(mesh, slots, kv):
    """The cases' layouts: each rank's head slot (first head, heads) and
    the KV heads it reads, a slot spanning two KV heads on each mesh and
    an empty one on (1, 4); the exchange's split matrix moves every column
    once (its rows are the column blocks, its columns the slots)."""
    from repro_torch.arch.layers import kv_range
    tp = MESHES[mesh][1]
    (_, H), (_, KV) = MID[mesh]
    cfg = get_config("qwen2-vl-7b-smoke").replace(**dict(MID[mesh]))
    assert [head_slots(H, tp, r) for r in range(tp)] == slots
    assert [kv_range(cfg, lo, n) for lo, n in slots] == kv
    hd = cfg.head_dim
    m = slot_splits(H, hd, tp)
    assert [sum(row) for row in m] == [H * hd // tp] * tp
    assert [sum(col) for col in zip(*m)] == [n * hd for _, n in slots]


@pytest.mark.parametrize("label", list(TRAIN))
def test_train_cell_matches_jax(world, label):
    """Each of two steps, from the JAX package's state before it: loss,
    grad norm, params and AdamW moments against its ``make_train_step``
    on the global batch; the cell takes no guard."""
    arch, m, _ = TRAIN[label]
    res = world[0][0][label]
    assert res["guarded"] == () and len(res["steps"]) == 2
    for i, (got, want) in enumerate(zip(res["steps"],
                                        _jax_steps(arch, m))):
        assert got["step"] == i + 1 and got["placements_kept"]
        _check_step(got, want, JO.AdamWConfig())


def _moment(state, leaf):
    return np.asarray(state["mu"]["blocks"]["pos0"]["attn"][leaf])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_caught(world, fault):
    """Each planted fault fails the comparison with the JAX package, and
    the leaf it corrupts is off by more than ``MOMENT_TOL``: a slot at the
    floor offset reads the wrong KV heads (``wk``'s gradient moves), an
    unsummed ``wk`` keeps each rank's part of its gradient, and the
    summing exchange gives each rank's q columns the others' gradients
    (``wq``)."""
    arch, m, _ = FAULT_CASE
    got = world[0][0][fault]["steps"][0]
    want = _jax_steps(arch, m)[0]
    with pytest.raises(AssertionError):
        _check_step(got, want, JO.AdamWConfig())
    leaf = {"slot_offset_floor": "wk", "attn_wk_no_model_sum": "wk",
            "slot_exchange_summing_backward": "wq"}[fault]
    with pytest.raises(AssertionError):
        _close_rel(_moment(got, leaf), _moment(want["end"], leaf),
                   MOMENT_TOL)


@pytest.mark.parametrize("label", list(SERVE))
def test_serve_cells_match_jax(world, label):
    """The prefill cell's last-token logits and k/v caches, and a decode
    step's logits and caches (with and without the distributed
    flash-decode), gathered whole, against the JAX package's
    ``make_prefill_step`` and ``make_decode_step`` on the same inputs."""
    arch, m = SERVE[label]
    got = world[1][0][label]
    logits, caches, dlogits, dcaches, lengths = _jax_serve(arch, m)
    tol = dict(rtol=0, atol=SERVE_ATOL)
    np.testing.assert_allclose(got["prefill_logits"], logits, **tol)
    assert got["prefill_placements"][-1] == "S(1)"      # vocab on model
    got_caches = tree_leaves(got["prefill_state"]["caches"])
    assert len(got_caches) == len(caches) == 2
    for w, g in zip(caches, got_caches):
        np.testing.assert_allclose(g, w, **tol)
    assert set(got["decode"]) == {False, True}
    for dist_decode, dec in got["decode"].items():
        np.testing.assert_allclose(dec["logits"], dlogits, **tol)
        for w, g in zip(dcaches, tree_leaves(dec["state"]["caches"])):
            np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_array_equal(dec["state"]["lengths"], lengths)
        assert dec["placements_kept"], dist_decode
    assert got["guarded"] == ()


CASES = [f"train:{k}" for k in TRAIN] + [f"serve:{k}" for k in SERVE]


def _calls(world, label):
    """Every rank's recorded calls of a case as (what, tally, account, the
    attention-kind leaves gathered over ``model``)."""
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
def test_no_attn_leaf_gathered_over_model(world, label):
    """No call all-gathers an attention-kind leaf over ``model``, none
    reaches DTensor's own collectives, and every call but the distributed
    decode (which gathers q's columns instead) exchanges its q and output
    by all-to-alls."""
    for what, tally, _, gathered in _calls(world, label):
        assert not [k for k in tally if k.startswith("functional:")], what
        assert not gathered, (what, gathered)
        assert ("all-to-all" in tally) == (what != "decode dist=True"), \
            (what, tally)


@pytest.mark.parametrize("label", CASES)
def test_collectives_match_the_dry_run(world, label):
    """Each rank's collectives a call (count and wire bytes, by kind)
    equal ``dryrun.account``'s for the same cell at its model
    coordinate."""
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


def test_midhead_world_rehearsed(smoke):
    """chip_smoke's phase 21 at smoke size on the CPU, in its world of 8
    on (1, 8): qwen2-vl-7b-smoke's 4 heads (KV 2) as half a head of q
    columns a rank, on slots of one head (ranks 4-7 empty). The train
    step, prefill and decode cells against the world of one at the pins,
    each rank's collectives equal to the dry run's, no attention weight
    gathered over ``model``, and the attention launches of a rank with a
    head and of one without (the phase checks itself)."""
    out = smoke.midhead_world_phase("cpu", arch="qwen2-vl-7b-smoke",
                                    layers=2, batch=2, seq=16, cache=16)
    assert set(out["calls"]) == {"train", "prefill", "decode dist=False",
                                 "decode dist=True"}
    first, last = out["ranks"][0], out["ranks"][-1]
    # 2 layers: a forward and its recompute, one backward; none on the
    # rank whose slot is empty
    assert first["train"]["launches"]["flash_attention"] == 4
    assert first["train"]["launches"]["flash_attention_backward"] == 2
    assert first["prefill"]["launches"]["flash_attention"] == 2
    assert not last["train"]["launches"].get("flash_attention")
    assert last["decode dist=True"]["launches"][
        "decode_attention_partial"] == 2


def test_midhead_per_rank_kernels_rehearsed(smoke):
    """chip_smoke's per-rank attention cases of the mid-head configs
    through the plain versions on the CPU: qwen2-vl-7b's slot of 2 heads
    over 2 KV heads and llama4-maverick's last slot of one head."""
    cases = [h for h in smoke.TP_HEADS
             if h[0] in ("qwen2-vl tp16", "maverick tp16 last slot")]
    assert [h[1:3] for h in cases] == [(2, 2), (1, 1)]
    out = smoke.tp_kernel_phase("cpu", heads=cases, time_it=False,
                                shapes=dict(B=1, S=128, Bd=2, Sd=128))
    for name in ("flash_attention", "flash_attention_backward",
                 "decode_attention"):
        assert len(out[name]) == 2
        for rec in out[name]:
            assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0, name
