"""Elastic restart in a gloo world of 4: the twin of
``tests/test_elastic_restore.py``. qwen3-1.7b-smoke's params and AdamW
state (after one train-cell step, f32) are saved sharded from a (2, 2)
("data", "model") mesh at ``baseline_rules`` placements; rank 3 is
"lost"; ``elastic_remesh([0, 1, 2], model_axis=2)`` (every rank calls
it) gives a (1, 2) mesh over ranks 0 and 1; the checkpoint restores onto
it at its ``param_shardings`` bit-equal to what was saved, the step in
the manifest kept and every leaf a DTensor of the new mesh; one more
step there equals the port's unsharded step from the restored state.
Then ``largest_mesh_shape`` against the JAX package's, and the sharded
checkpoint format and the supervisor's ``shardings=`` on one process."""
import json

import numpy as np
import pytest
import torch

from _torch_dist_worker import elastic_world, failed_write_world, run_world
from repro.distributed import fault as JF
from repro_torch.arch import model as TM
from repro_torch.arch.params import params_from_numpy, tree_leaves
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import synthetic as TD
from repro_torch.distributed import checkpoint as TC
from repro_torch.distributed import fault as TF
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

torch.set_num_threads(1)

ARCH = "qwen3-1.7b-smoke"
B, S = 8, 16
# the step on the new mesh against the unsharded step from the restored
# state: tests/test_torch_lm_train.py's pins (loss, grad norm, params)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5


def _setup():
    cfg = get_config(ARCH).replace(dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    np_params = TC.tree_map(lambda t: t.numpy(), params)
    batches = [{k: v.numpy() for k, v in TD.synthetic_batch_for(
        cfg, ShapeSpec("t", S, B, "train"), seed=s, device="cpu").items()}
        for s in (11, 12)]
    return cfg, np_params, batches


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg, np_params, batches = _setup()
    d = tmp_path_factory.mktemp("elastic")
    ranks = run_world(elastic_world, 4, d, ARCH, np_params, batches,
                      str(d / "ck"), [0, 1, 2], timeout=300)
    return cfg, batches, ranks, d / "ck"


def test_checkpoint_is_sharded_one_file_a_rank(world):
    """Every rank of the (2, 2) mesh writes ``shard-<rank>.npz``; each
    element is written once (a leaf replicated over ``model`` by the
    rank at model coordinate 0); the manifest names the world, the mesh
    and each leaf's placements."""
    _, _, _, ck = world
    manifest = json.loads((ck / "manifest.json").read_text())
    assert manifest["process_count"] == 4 and manifest["step"] == 5
    assert sorted(p.name for p in ck.iterdir()) == \
        ["manifest.json"] + [f"shard-{r}.npz" for r in range(4)]
    files = [np.load(ck / f"shard-{r}.npz") for r in range(4)]
    for i, meta in enumerate(manifest["leaves"]):
        assert meta["mesh"] == [[0, 1], [2, 3]]
        assert meta["mesh_dim_names"] == ["data", "model"]
        writers = [r for r in range(4) if f"a{i}" in files[r].files]
        written = sum(files[r][f"a{i}"].size for r in writers)
        assert written == int(np.prod(meta["shape"])), meta
        if meta["placements"][1] == "R":
            assert all(r % 2 == 0 for r in writers)


def test_remesh_on_three_survivors(world):
    _, _, ranks, _ = world
    assert JF.largest_mesh_shape(3, model_axis=2) == (1, 2)
    for r in ranks:
        assert r["mesh_shape"] == (1, 2) and r["mesh_ranks"] == [[0, 1]]
    assert "restored" not in ranks[2] and "restored" not in ranks[3]


def test_restore_onto_the_shrunken_mesh_is_bit_equal(world):
    _, _, ranks, _ = world
    saved = ranks[0]["saved"]
    for r in ranks[:2]:
        assert r["manifest"]["step"] == 5 and r["on_new_mesh"]
        got = r["restored"]
        for a, b in zip(TC.flatten(saved), TC.flatten(got)):
            np.testing.assert_array_equal(a, b)
        assert got["opt"].step.shape == () and int(got["opt"].step) == 1


def test_training_continues_on_the_new_mesh(world):
    cfg, batches, ranks, _ = world
    restored = ranks[0]["restored"]
    params = params_from_numpy(restored["params"], "cpu")
    state = TO.AdamWState(torch.tensor(restored["opt"].step),
                          params_from_numpy(restored["opt"].mu, "cpu"),
                          params_from_numpy(restored["opt"].nu, "cpu"))
    p, o, m = TS.make_train_step(cfg)(params, state, {
        k: torch.from_numpy(v) for k, v in batches[1].items()})
    got = ranks[0]["next"]
    assert ranks[1]["next"]["metrics"] == got["metrics"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               float(m["grad_norm"]), rtol=NORM_RTOL)
    for w, g in zip(tree_leaves(p), tree_leaves(got["params"])):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=PARAM_ATOL)


def test_a_failed_shard_write_raises_on_every_rank(tmp_path):
    """A rank's failed shard write (its ``np.savez`` raising, as on a full
    disk) raises on every rank of the mesh, through ``save_async`` +
    ``wait`` and through ``save``: the rank that failed its own error,
    the others a ``RuntimeError``, none waiting on it (the world's
    timeout would fail the test); the last complete checkpoint stays the
    latest and restores."""
    ranks = run_world(failed_write_world, 4, tmp_path, str(tmp_path / "ck"),
                      1, timeout=120)
    for r, got in enumerate(ranks):
        want = "OSError" if r == 1 else "RuntimeError"
        assert (got["save_async"], got["save"]) == (want, want), (r, got)
        assert got["latest"] == 1
        np.testing.assert_array_equal(got["restored"],
                                      np.arange(32.0).reshape(4, 8))


@pytest.mark.parametrize("lo", range(1, 4097, 512))
def test_largest_mesh_shape_matches_jax(lo):
    for n in range(lo, min(lo + 512, 4097)):
        for model_axis in (16, 4, 2):
            assert TF.largest_mesh_shape(n, model_axis=model_axis) == \
                JF.largest_mesh_shape(n, model_axis=model_axis)


def test_sharded_checkpoint_restores_plain_and_into_one_process(tmp_path):
    """A sharded checkpoint of a world of one (a (1, 1) gloo mesh) keeps
    the one-file tree's leaves, restores into plain tensors and onto
    ``shardings``; a plain tree keeps the one-file format."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_mesh
    from _torch_dist_worker import _free_port
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "b": torch.arange(3, dtype=torch.bfloat16)}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pls = {"w": (Shard(0), Shard(1)), "b": (Replicate(), Replicate())}
        placed = {k: place(v, mesh, pls[k]) for k, v in tree.items()}
        mgr = TC.CheckpointManager(tmp_path / "m", keep=1)
        mgr.save_async(placed, step=2)
        mgr.wait()
        manifest = json.loads((tmp_path / "m" / "step-2" /
                               "manifest.json").read_text())
        assert manifest["process_count"] == 1 and len(manifest["leaves"]) == 2
        plain, _ = TC.restore(tmp_path / "m" / "step-2", tree)
        assert all(torch.equal(plain[k], tree[k]) for k in tree)
        again, _ = mgr.restore_latest(
            tree, shardings={k: (mesh, pls[k]) for k in tree})
        assert all(isinstance(again[k], DTensor)
                   and tuple(again[k].placements) == pls[k]
                   and torch.equal(again[k].full_tensor(), tree[k])
                   for k in tree)
        sup = TF.TrainSupervisor(TC.CheckpointManager(tmp_path / "s"),
                                 checkpoint_every=1)
        fail = {"at": 2}

        def step_fn(state, batch):
            if fail["at"] == batch:
                fail["at"] = -1
                raise TF.NodeFailure("injected")
            return {k: v + 1 for k, v in state.items()}
        state, rep = sup.run(placed, iter(range(10)), step_fn, num_steps=3,
                             shardings={k: (mesh, pls[k]) for k in tree})
        assert (rep.failures_handled, rep.restores, rep.final_step) == \
            (1, 1, 3)
        assert torch.equal(state["w"].full_tensor(), tree["w"] + 3)
    finally:
        dist.destroy_process_group()
    TC.save(tmp_path / "plain", tree, step=0)
    assert sorted(p.name for p in (tmp_path / "plain").iterdir()) == \
        ["manifest.json", "shard-0.npz"]
    assert "leaves" not in json.loads(
        (tmp_path / "plain" / "manifest.json").read_text())
