"""The port's checkpointing and supervised restart against the JAX
package's, on the CPU: a checkpoint written by either package (params and
AdamW state of a smoke model, the reference's ``shard-0.npz`` +
``manifest.json`` format, leaves in its flatten order) restores into the
other bitwise; the manager's async double-buffered saves, retention and
error propagation; ``TrainSupervisor`` with an injected failure ends on
the same params as an uninterrupted run, and on the JAX package's params
for the same run; the device error it restarts from, and the errors it
does not catch."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.arch import model as JM
from repro.distributed import checkpoint as JC
from repro.distributed import fault as JF
from repro.train import optim as JO
from repro.train import step as JS
from repro_torch.arch import model as TM
from repro_torch.arch.params import params_from_numpy, tree_leaves
from repro_torch.configs import get_config
from repro_torch.data import synthetic as TD
from repro_torch.distributed import checkpoint as TC
from repro_torch.distributed import fault as TF
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

torch.set_num_threads(1)

# three supervised AdamW steps of the f32 smoke model, the two packages
# against each other: tests/test_torch_lm_train.py's PARAM_ATOL
PARAM_ATOL = 2e-5
ARCH = "qwen3-1.7b-smoke"


def _jax_state(seed=0, steps=1):
    """The JAX package's {"params", "opt"} after ``steps`` AdamW updates
    with seeded gradients (so the moments are not zero)."""
    cfg = get_config(ARCH)
    params = JM.init_params(cfg, jax.random.PRNGKey(seed))
    opt = JO.init_state(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        params, opt, _ = JO.apply_update(params, g, opt, JO.AdamWConfig())
    return {"params": params, "opt": opt}


def _port_like(cfg=None):
    cfg = cfg or get_config(ARCH)
    params = TM.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    return {"params": params, "opt": TO.init_state(params)}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_flatten_order_is_the_references():
    """The port's flatten of {"params", "opt": AdamWState} visits leaves
    in jax.tree_util's order (dict keys sorted, NamedTuple fields)."""
    js = _jax_state()
    ts = {"params": params_from_numpy(
              jax.tree_util.tree_map(np.asarray, js["params"]), "cpu"),
          "opt": TO.AdamWState(
              torch.tensor(np.asarray(js["opt"].step)),
              params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       js["opt"].mu), "cpu"),
              params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       js["opt"].nu), "cpu"))}
    for a, b in zip(_np_leaves(js), TC.flatten(ts)):
        np.testing.assert_array_equal(b.numpy(), a)
    assert len(TC.flatten(ts)) == len(_np_leaves(js))


def test_jax_checkpoint_restores_into_port(tmp_path):
    js = _jax_state(seed=2, steps=2)
    JC.save(tmp_path / "ck", js, step=7, extra={"who": "jax"})
    like = _port_like()
    got, manifest = TC.restore(tmp_path / "ck", like)
    assert manifest["step"] == 7 and manifest["extra"] == {"who": "jax"}
    assert isinstance(got["opt"], TO.AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 2
    for a, b in zip(_np_leaves(js), TC.flatten(got)):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(TC.flatten(got), TC.flatten(like)):
        assert a.dtype == b.dtype and a.device == b.device


def test_port_checkpoint_restores_into_jax(tmp_path):
    ts = _port_like()
    params, opt = ts["params"], ts["opt"]
    g = tree_leaves(params)
    grads = TS._unflatten(params, [torch.randn_like(x) for x in g])
    params, opt, _ = TO.apply_update(params, grads, opt, TO.AdamWConfig())
    ts = {"params": params, "opt": opt}
    TC.save(tmp_path / "ck", ts, step=3)
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(TC.flatten(ts))
    assert manifest["process_count"] == 1
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["manifest.json", "shard-0.npz"]
    restored, jm = JC.restore(tmp_path / "ck", _jax_state())
    assert jm["step"] == 3
    for a, b in zip(_np_leaves(restored), TC.flatten(ts)):
        np.testing.assert_array_equal(a, b.numpy())


def test_restore_checks_the_leaf_count(tmp_path):
    TC.save(tmp_path / "ck", {"a": torch.zeros(2)}, step=0)
    with pytest.raises(ValueError, match="1 leaves, the tree has 2"):
        TC.restore(tmp_path / "ck", {"a": torch.zeros(2), "b": torch.ones(1)})


def test_bf16_leaves_round_trip(tmp_path):
    t = {"w": torch.randn(3, 5).to(torch.bfloat16), "n": None,
         "s": (torch.arange(4, dtype=torch.int32),)}
    TC.save(tmp_path / "ck", t, step=1)
    got, _ = TC.restore(tmp_path / "ck", t)
    assert got["n"] is None and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], t["w"]) and torch.equal(got["s"][0], t["s"][0])


def test_manager_async_retention_and_latest(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(4)}
    for step in (1, 2, 3, 4):
        tree = {"x": tree["x"] + 1}
        mgr.save_async(tree, step=step)
        tree["x"].add_(100)       # the snapshot was taken at save time
    mgr.wait()
    assert TC.latest_step(str(tmp_path)) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-3", "step-4"]
    got, manifest = mgr.restore_latest({"x": torch.zeros(4)})
    assert manifest["step"] == 4 and got["x"].tolist() == [304.0] * 4
    assert TC.latest_step(str(tmp_path / "none")) is None
    empty = TC.CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore_latest(tree) == (None, None)


def test_manager_reraises_a_failed_write(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path))
    (tmp_path / "step-1.tmp").write_text("")  # a file where the write goes
    mgr.save_async({"x": torch.zeros(1)}, step=1)
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    mgr.wait()                                # the error is raised once


def test_health_monitor_and_mesh_shape_match_jax():
    for n in (1, 2, 3, 8, 17, 64, 100, 512):
        for axis in (1, 4, 16):
            assert TF.largest_mesh_shape(n, model_axis=axis) == \
                JF.largest_mesh_shape(n, model_axis=axis)
    mon = TF.HealthMonitor(heartbeat_timeout_s=10.0)
    for node in (0, 1, 2):
        mon.beat(node, now=100.0)
    mon.beat(2, now=115.0)
    mon.inject_failure(1)
    assert mon.alive(now=112.0) == [2] and mon.dead(now=112.0) == [0, 1]
    with pytest.raises(TF.NodeFailure):
        mon.beat(1)
    mon.heal(1)
    mon.beat(1, now=112.0)
    assert mon.alive(now=112.0) == [1, 2]


def _supervised(tmp_path, fail_at, steps=6, every=2, batches=None):
    """The launcher's loop on the f32 smoke model over ``batches`` (the
    synthetic stream by default): returns (params, report, losses)."""
    cfg = get_config(ARCH).replace(dtype="float32")
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0))), "cpu")
    step_fn = TS.make_train_step(cfg)
    stream = batches if batches is not None else \
        TD.SyntheticTokenStream(cfg.vocab_size, 4, 16, device="cpu")
    losses, fail = [], {"n": fail_at}

    def step(st, batch):
        if fail["n"] == len(losses):
            fail["n"] = -1
            raise TF.NodeFailure("injected")
        p, o, m = step_fn(st["params"], st["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    sup = TF.TrainSupervisor(TC.CheckpointManager(str(tmp_path)),
                             checkpoint_every=every)
    state, rep = sup.run({"params": params, "opt": TO.init_state(params)},
                         iter(stream), step, num_steps=steps)
    return state, rep, losses


def test_supervisor_restart_ends_on_the_uninterrupted_params(tmp_path):
    """A failure in step 4 (its batch drawn, then lost, as in the
    reference) restores step 2's checkpoint: steps 3-4 are redone on the
    next batches. An uninterrupted run over the batches the interrupted
    run trained on ends on bitwise the same params and step count."""
    stream = TD.SyntheticTokenStream(128, 4, 16, device="cpu")
    batches = [stream.next() for _ in range(9)]
    hit, rep1, losses = _supervised(tmp_path / "b", fail_at=3,
                                    batches=batches)
    # trained on: 0, 1, 2 (lost in the restore), [3: drawn, failed], 4, ...
    clean, rep0, _ = _supervised(tmp_path / "a", fail_at=-1,
                                 batches=batches[:2] + batches[4:])
    assert (rep0.failures_handled, rep0.restores) == (0, 0)
    assert (rep1.failures_handled, rep1.restores, rep1.steps_run) == (1, 1, 7)
    assert rep1.final_step == rep0.final_step == 6 and len(losses) == 7
    for a, b in zip(TC.flatten(clean), TC.flatten(hit)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_supervisor_matches_jax_supervisor(tmp_path):
    """The same supervised run (failure injected at step 3, checkpoints
    every 2) in both packages from the same params: the restore count, the
    final step and the params."""
    cfg = get_config(ARCH).replace(dtype="float32")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    jstep = JS.make_train_step(cfg)
    from repro.data.synthetic import SyntheticTokenStream
    losses, fail = [], {"n": 3}

    def step(st, batch):
        if fail["n"] == len(losses):
            fail["n"] = -1
            raise JF.NodeFailure("injected")
        p, o, m = jstep(st["params"], st["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    sup = JF.TrainSupervisor(JC.CheckpointManager(str(tmp_path / "j")),
                             checkpoint_every=2)
    jstate, jrep = sup.run({"params": jparams, "opt": JO.init_state(jparams)},
                           iter(SyntheticTokenStream(cfg.vocab_size, 4, 16)),
                           step, num_steps=6)
    tstate, trep, tlosses = _supervised(tmp_path / "t", fail_at=3)
    assert (trep.restores, trep.final_step, trep.steps_run) == \
        (jrep.restores, jrep.final_step, jrep.steps_run)
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    for a, b in zip(_np_leaves(jstate), TC.flatten(tstate)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=PARAM_ATOL)


def test_supervisor_catches_device_errors_not_bugs(tmp_path):
    assert TF.DEVICE_ERRORS == (torch.AcceleratorError,)
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save_sync({"x": torch.zeros(1)}, step=0)
    raised = []

    def flaky(st, batch):
        if not raised:
            raised.append(1)
            raise torch.AcceleratorError("CUDA error: an illegal memory access")
        return {"x": st["x"] + 1}

    state, rep = TF.TrainSupervisor(mgr, checkpoint_every=10).run(
        {"x": torch.zeros(1)}, iter(range(10)), flaky, num_steps=3)
    assert rep.failures_handled == 1 and float(state["x"][0]) == 3.0

    def buggy(st, batch):
        raise RuntimeError("a fault of the program")

    with pytest.raises(RuntimeError, match="fault of the program"):
        TF.TrainSupervisor(mgr).run({"x": torch.zeros(1)}, iter(range(3)),
                                    buggy, num_steps=3)


def test_supervisor_preemption_checkpoints_and_stops(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path))
    sup = TF.TrainSupervisor(mgr, checkpoint_every=100)

    def step(st, batch):
        if batch == 1:
            sup.request_preemption()
        return {"x": st["x"] + 1}

    state, rep = sup.run({"x": torch.zeros(1)}, iter(range(10)), step,
                         num_steps=10)
    assert rep.preempted and rep.final_step == 2
    got, manifest = TC.restore(mgr.dir_for(2), {"x": torch.zeros(1)})
    assert manifest["extra"] == {"preempted": True} and float(got["x"]) == 2


def test_launcher_survives_an_injected_failure(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU: one failure
    handled, one restore, the final checkpoint written and restorable."""
    from repro_torch.launch import train as launch
    losses, state, rep, ckpt = launch.run(
        ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
         "--seq", "16", "--checkpoint-every", "2", "--inject-failure-at",
         "3", "--checkpoint-dir", str(tmp_path)])
    assert (rep.failures_handled, rep.restores, rep.final_step) == (1, 1, 6)
    assert len(losses) == 7 and np.isfinite(losses).all()
    assert TC.latest_step(str(ckpt.root)) == 6
    got, _ = ckpt.restore_latest(state)
    for a, b in zip(TC.flatten(got), TC.flatten(state)):
        assert torch.equal(a, b)
