"""The port's dry run (``launch/cells.py``, ``launch/dryrun.py``) on the
CPU with no process group: ``auto_microbatches`` against the JAX
package's on every arch x train shape x production mesh (the JAX
function reads only ``mesh.shape`` and ``mesh.axis_names``, so stand-in
meshes serve); the accounting against the reference test's own bounds
(``tests/test_dryrun_machinery.py``) on a (2, 4) mesh; the per-device
parameter bytes against what the JAX package's ``param_shardings``
implies; and ``python -m repro_torch.launch.dryrun --all`` in a
subprocess, which loads neither ``jax`` nor ``repro``. dbrx-132b's,
zamba2-2.7b's and rwkv6-7b's cells on the pod mesh: their experts, SSD
heads and shared block, WKV heads and channel-mix columns on shards."""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import repro.distributed.sharding as JS
from repro.arch import model as JM
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import cells as JCells
from repro_torch.arch.params import tree_leaves
from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import serve_rules
from repro_torch.launch import cells as TCells
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, make_production_mesh

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
TRAIN_SHAPES = [s for s in SHAPES if SHAPES[s].kind == "train"]


def _jax_mesh(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_auto_microbatches_match_jax(arch, mesh):
    shape, axes = MESHES[mesh]
    for s in TRAIN_SHAPES:
        want = JCells.auto_microbatches(jax_get_config(arch), JSHAPES[s],
                                        _jax_mesh(shape, axes))
        got = TCells.auto_microbatches(get_config(arch), SHAPES[s],
                                       MeshShape(shape, axes))
        assert got == want


def test_production_mesh_is_a_stand_in_without_a_world():
    m = make_production_mesh()
    assert isinstance(m, MeshShape) and m.size() == 256
    assert make_production_mesh(multi_pod=True).mesh_dim_names == \
        ("pod", "data", "model")


def test_train_flops_within_the_reference_bounds(tmp_path):
    """qwen3-1.7b ``train_4k`` on (2, 4): the operations a device does in
    a step lie within 0.8-2.0 x 6 N D / 8 (N = 1.72e9, D = 256 x 4096),
    the remat factor's bounds in ``tests/test_dryrun_machinery.py``. The
    rows spread over the data axis alone (2 slices of the batch, 128 rows
    a device); the model axis splits heads, columns and vocabulary."""
    mesh = MeshShape((2, 4), ("data", "model"))
    r = dryrun.run_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                        out_dir=tmp_path, mesh=mesh)
    n, d = 1.72e9, 256 * 4096
    model = 6 * n * d / 8
    assert 0.8 * model < r["cost"]["flops"] < 2.0 * model, r["cost"]
    assert r["batch_split"] == 2 and r["rows_per_device"] == 128
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    assert (tmp_path / "qwen3-1.7b__train_4k__2x4.json").exists()


def test_dist_decode_slashes_the_wire_bytes(tmp_path):
    """``decode_32k`` with ``serve_rules`` and the distributed
    flash-decode moves less than half the baseline's collective bytes
    (the reference test's bound): no cache gather, three stats
    all-reduces a layer, beside the two tensor-parallel partial sums a
    layer and the embedding's."""
    mesh = MeshShape((2, 4), ("data", "model"))
    base = dryrun.run_cell("qwen3-1.7b", "decode_32k", multi_pod=False,
                           out_dir=tmp_path, mesh=mesh)
    opt = dryrun.run_cell("qwen3-1.7b", "decode_32k", multi_pod=False,
                          out_dir=tmp_path, mesh=mesh,
                          rules=serve_rules(False), dist_decode=True)
    wire = lambda r: r["cost"]["collective_wire_bytes"]  # noqa: E731
    assert wire(opt) < 0.5 * wire(base), (wire(opt), wire(base))
    assert opt["cost"]["collective_counts"]["all-reduce"] == \
        3 * 28 + 2 * 28 + 1
    assert opt["cost"]["flops"] == base["cost"]["flops"]


@pytest.fixture
def jax_specs(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def _jax_local_bytes(arch, shape, axes, rules, nbytes) -> float:
    mesh = _jax_mesh(shape, axes)
    specs = JM.build_param_specs(jax_get_config(arch))
    total = 0.0
    for s, spec in zip(
            jax_tree_leaves(specs),
            jax_tree_leaves(JS.param_shardings(mesh, rules, specs))):
        ext = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ext *= mesh.shape[a]
        total += math.prod(s.shape) * nbytes / ext
    return total


def jax_tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_tree_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_bytes_match_jax_shardings(mesh, jax_specs, tmp_path):
    """A device's parameter bytes in each train cell (f32) and decode cell
    (bf16, serve rules) equal what the JAX package's ``param_shardings``
    implies on the same stand-in mesh."""
    shape, axes = MESHES[mesh]
    multi = "pod" in axes
    for arch in list_archs():
        for kind, rules, nbytes in (("train_4k", None, 4),
                                    ("prefill_32k", "serve", 2)):
            kw = {"rules": serve_rules(multi)} if rules else {}
            r = dryrun.run_cell(arch, kind, multi_pod=multi,
                                out_dir=tmp_path, **kw)
            jr = JS.serve_rules(multi) if rules else JS.baseline_rules(multi)
            want = _jax_local_bytes(arch, shape, axes, jr, nbytes)
            assert r["memory"]["param_bytes"] == pytest.approx(want,
                                                               rel=1e-12)


def test_roofline_and_custom_cell(tmp_path):
    """A cell of one's own shape on a (1, 1) mesh: everything on one
    device, no collective moves a byte, and the roofline's terms are the
    count over the card's peaks."""
    mesh = MeshShape((1, 1), ("data", "model"))
    r = dryrun.run_cell("qwen3-1.7b", ShapeSpec("a", 1024, 4, "train"),
                        multi_pod=False, out_dir=tmp_path, mesh=mesh,
                        microbatches=1)
    assert r["cost"]["collective_wire_bytes"] == 0
    assert r["roofline"]["compute_s"] == r["cost"]["flops"] / 989e12
    assert r["roofline"]["memory_s"] == r["cost"]["bytes"] / 3.35e12
    assert r["roofline"]["card"].startswith("NVIDIA H100")
    cell = TCells.build_cell("qwen3-1.7b", "train_4k", mesh)
    assert all(t.device.type == "meta" for t in tree_leaves(cell.args[0]))


def _clean_env():
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "HOME": os.environ.get("HOME", "/tmp"),
            "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}


def test_cli_all_runs_without_jax_or_a_world(tmp_path):
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--all', '--out', sys.argv[1]]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "import torch.distributed as dist\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "assert not dist.is_initialized()\n"
            "print('CLEAN')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          env=_clean_env(), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "CLEAN"
    want, skipped = set(), set()
    for arch in list_archs():
        cfg = get_config(arch)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            if ok:
                want.add(f"{arch}__{s.name}__pod.json")
            else:
                skipped.add(f"SKIP {arch} x {s.name}: {why}")
    assert {p.name for p in tmp_path.glob("*.json")} == want
    assert skipped == {ln for ln in lines if ln.startswith("SKIP")}
    assert sum(ln.startswith("OK  ") for ln in lines) == len(want)
    one = json.loads((tmp_path / "qwen3-1.7b__train_4k__pod.json")
                     .read_text())
    assert set(one) >= {"memory", "cost", "roofline", "mesh", "n_devices"}
    assert set(one["cost"]) == {"flops", "bytes", "collective_wire_bytes",
                                "collectives", "collective_counts"}
    assert one["n_devices"] == 256


def test_cli_refuses_keep_hlo(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "train_4k", "--keep-hlo", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        env=_clean_env(), cwd=tmp_path)
    assert proc.returncode == 2 and "--keep-hlo" in proc.stderr
    assert not list(tmp_path.glob("*.json"))


def test_internlm2_train_fits_a_card_and_splits_its_work(tmp_path):
    """internlm2-20b ``train_4k`` on the (16, 16) pod mesh: one device's
    peak under one card's 80e9 B (228 GiB while the cell gathered every
    parameter whole), and its operations those of the (16, 1) mesh (the
    same rows a device) over the model extent of 16, within 2 %, once the
    KV projections are counted as a rank computes them: its three q heads
    read one KV head (G 6), which the two ranks reading it each compute,
    against a 16th of the 8."""
    cfg = get_config("internlm2-20b")
    pod = dryrun.run_cell("internlm2-20b", "train_4k", multi_pod=False,
                          out_dir=tmp_path)
    one = dryrun.run_cell("internlm2-20b", "train_4k", multi_pod=False,
                          out_dir=tmp_path,
                          mesh=MeshShape((16, 1), ("data", "model")))
    assert pod["memory"]["peak_per_device_bytes"] < 80e9, pod["memory"]
    assert pod["rows_per_device"] == one["rows_per_device"] == 16
    assert pod["layout"]["attention_split"] == ["pos0"]
    tokens = pod["rows_per_device"] * SHAPES["train_4k"].seq_len
    # k and v, 2 operations a multiply-add, forward + recompute + backward
    kv = tokens * 4 * cfg.num_layers * 2 * 2 * cfg.d_model * cfg.head_dim \
        * (1 - cfg.num_kv_heads / 16)
    ideal = one["cost"]["flops"] / 16
    assert abs(pod["cost"]["flops"] - kv - ideal) < 0.02 * ideal


MOE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def dbrx_cells(tmp_path_factory):
    """dbrx-132b's cells on the (16, 16) pod mesh, and its train cell on
    the (16, 1) mesh (the same 16 rows a device, no model axis)."""
    out = tmp_path_factory.mktemp("dbrx")
    pod = {s: dryrun.run_cell("dbrx-132b", s, multi_pod=False, out_dir=out)
           for s in MOE_SHAPES}
    pod.update({f"{s} optimized": dryrun.run_cell(
        "dbrx-132b", s, multi_pod=False, out_dir=out, optimized=True)
        for s in MOE_SHAPES[1:]})
    one = dryrun.run_cell("dbrx-132b", "train_4k", multi_pod=False,
                          out_dir=out, mesh=MeshShape((16, 1),
                                                      ("data", "model")))
    return pod, one


def test_dbrx_expert_flops_fall_by_the_model_extent(dbrx_cells):
    """dbrx-132b ``train_4k``: each rank computes its 1 of 16 experts, so a
    device's operations on the pod mesh are those of the (16, 1) mesh's
    (every expert on every device, 99 % of its count) over the model
    extent of 16, within 2 %, once the parts every rank repeats are
    counted as it computes them: the router (d x E a token) and the KV
    projections of its three q heads' one KV head (of 8, a 16th each on
    the (16, 1) mesh)."""
    pod, one = dbrx_cells
    cfg = get_config("dbrx-132b")
    p = pod["train_4k"]
    assert p["rows_per_device"] == one["rows_per_device"] == 16
    assert p["cost"]["flops"] <= 2.1e15, p["cost"]["flops"]
    tokens = p["rows_per_device"] * SHAPES["train_4k"].seq_len
    # 2 operations a multiply-add, forward + recompute + the 2 backward
    router = tokens * 4 * cfg.num_layers * 2 * cfg.d_model \
        * cfg.num_experts * (1 - 1 / 16)
    kv = tokens * 4 * cfg.num_layers * 2 * 2 * cfg.d_model * cfg.head_dim \
        * (1 - cfg.num_kv_heads / 16)
    ideal = one["cost"]["flops"] / 16
    assert abs(p["cost"]["flops"] - router - kv - ideal) < 0.02 * ideal
    assert p["layout"]["model_extent"] == 16


@pytest.mark.parametrize("shape", list(MOE_SHAPES) + [
    f"{s} optimized" for s in MOE_SHAPES[1:]])
def test_dbrx_cells_fit_a_card(dbrx_cells, shape):
    """dbrx-132b on the pod mesh: a device's peak under one card's 80e9 B
    at each shape, with the baseline and the serving rules (1438.63,
    282.82 and 282.45 GiB while the cells gathered every expert whole)."""
    mem = dbrx_cells[0][shape]["memory"]
    assert mem["peak_per_device_bytes"] < 80e9, mem


@pytest.mark.parametrize("shape", list(MOE_SHAPES) + [
    f"{s} optimized" for s in MOE_SHAPES[1:]])
def test_dbrx_param_bytes_match_jax_shardings(dbrx_cells, shape, jax_specs):
    """A device's parameter bytes in dbrx-132b's cells equal what the JAX
    package's ``param_shardings`` implies: computing on the expert shards
    moves no parameter's placement."""
    r = dbrx_cells[0][shape]
    serve = shape.endswith("optimized")
    train = shape == "train_4k"
    rules = JS.serve_rules(False) if serve else JS.baseline_rules(False)
    want = _jax_local_bytes("dbrx-132b", *MESHES["pod"], rules,
                            4 if train else 2)
    assert r["memory"]["param_bytes"] == pytest.approx(want, rel=1e-12)


ZAMBA_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def zamba_cells(tmp_path_factory):
    """zamba2-2.7b's cells on the (16, 16) pod mesh (the serve cells also
    ``--optimized``), and on the (16, 1) mesh (the same rows a device, no
    model axis)."""
    out = tmp_path_factory.mktemp("zamba2")
    pod = {s: dryrun.run_cell("zamba2-2.7b", s, multi_pod=False,
                              out_dir=out) for s in ZAMBA_SHAPES}
    pod.update({f"{s} optimized": dryrun.run_cell(
        "zamba2-2.7b", s, multi_pod=False, out_dir=out, optimized=True)
        for s in ZAMBA_SHAPES[1:]})
    one = {s: dryrun.run_cell("zamba2-2.7b", s, multi_pod=False,
                              out_dir=out, mesh=MeshShape((16, 1),
                                                          ("data", "model")))
           for s in ZAMBA_SHAPES}
    return pod, one


@pytest.mark.parametrize("shape", list(ZAMBA_SHAPES) + [
    f"{s} optimized" for s in ZAMBA_SHAPES[1:]])
def test_zamba2_layout_names_its_mixer_split(zamba_cells, shape):
    """The layout field of zamba2-2.7b's cells on (16, 16): every Mamba2
    position on 5 of 80 SSD heads a rank, ``in_proj``'s route by the
    cell's kind, the shared block's attention and MLP split; on (16, 1)
    nothing splits."""
    r = zamba_cells[0][shape]
    split = r["layout"]["mamba_split"]
    assert split["positions"] == [f"pos{j}" for j in range(6)]
    assert split["ssd_heads_per_rank"] == 5
    assert split["in_proj_route"] == (
        "activation" if shape.startswith("decode") else "weight")
    assert r["layout"]["shared_split"] == {"attention": True, "mlp": True}
    assert r["layout"]["guarded"] == []
    assert r["rows_per_device"] == zamba_cells[1][
        shape.split()[0]]["rows_per_device"]
    flat = zamba_cells[1][shape.split()[0]]["layout"]["mamba_split"]
    assert flat == {"positions": [], "ssd_heads_per_rank": 0,
                    "in_proj_route": ""}


@pytest.mark.parametrize("shape,mesh,want", [
    ("prefill_32k", (16, 16), True), ("prefill_32k", (1, 2), False),
    ("decode_32k", (16, 16), False), ("train_4k", (16, 16), False)])
def test_zamba2_kv_cache_chunks_decided_by_the_cell(shape, mesh, want):
    """The cell decides once whether its prefill writes the shared block's
    k/v caches at a rank's sequence chunk (``Cell.kv_chunks``): on (16,
    16) each rank's 2 KV heads over the whole sequence and all 32 over its
    chunk cost less than all 32 over the whole sequence; on a model
    extent of 2 they never do; decode and train cells write none. The
    dry run's layout reports the cell's choice."""
    cell = TCells.build_cell("zamba2-2.7b", shape, MeshShape(
        mesh, ("data", "model")))
    assert cell.kv_chunks is want
    assert TCells.kv_cache_chunks(cell.cfg, cell.mesh, cell.rules,
                                  cell.kind, cell.shape.seq_len) is want
    if shape == "prefill_32k" and mesh == (16, 16):
        r = dryrun.account(cell)
        assert r["layout"]["kv_cache_chunks"] is True


@pytest.mark.parametrize("shape", ZAMBA_SHAPES)
def test_zamba2_ssd_count_is_a_rank_s_heads(zamba_cells, shape):
    """The SSD scan's term of a device's operations on (16, 16) is a 16th
    of the (16, 1) mesh's, whose ranks scan all 80 heads: ``_per_token``'s
    scan term on each layout, less the conv's (its B and C channels every
    rank repeats)."""
    cell = TCells.build_cell("zamba2-2.7b", shape, MeshShape(
        (16, 16), ("data", "model")))
    lay = dryrun.layout(cell, cell.shape.seq_len)
    flat = dryrun.layout(TCells.build_cell(
        "zamba2-2.7b", shape, MeshShape((16, 1), ("data", "model"))),
        cell.shape.seq_len)
    cfg, S = cell.cfg, cell.shape.seq_len
    decode = shape.startswith("decode")
    n = cfg.num_periods * 6
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    conv = lambda ch: n * 2 * cfg.ssm_conv * ch                # noqa: E731
    got = dryrun._per_token(cfg, S, S, decode, 0.0, 2, lay, True)[4] \
        - conv(5 * P + 2 * N)
    whole = dryrun._per_token(cfg, S, S, decode, 0.0, 2, flat, True)[4] \
        - conv(80 * P + 2 * N)
    assert lay.ssd_split == 16 and flat.ssd_split == 1
    assert got * 16 == pytest.approx(whole, rel=1e-12)


def test_zamba2_cells_count_their_shards(zamba_cells):
    """zamba2-2.7b on (16, 16): prefill_32k at most 5e13 flop a device
    (5.99e14 while every model rank computed its two rows whole); decode
    under the serving rules moves no weight over ``model`` (below 1e8 B
    on the wire, 5.16e9 before); the train cell's rows over the data
    axis alone (16 a device) and every cell under one card's 80e9 B."""
    pod, _ = zamba_cells
    assert pod["prefill_32k"]["cost"]["flops"] <= 5e13
    assert pod["decode_32k optimized"]["cost"]["collective_wire_bytes"] \
        < 1e8
    assert pod["train_4k"]["rows_per_device"] == 16
    for r in pod.values():
        assert r["memory"]["peak_per_device_bytes"] < 80e9, r["memory"]


@pytest.mark.parametrize("shape", list(ZAMBA_SHAPES) + [
    f"{s} optimized" for s in ZAMBA_SHAPES[1:]])
def test_zamba2_param_bytes_match_jax_shardings(zamba_cells, shape,
                                                jax_specs):
    """A device's parameter bytes in zamba2-2.7b's cells equal what the
    JAX package's ``param_shardings`` implies: computing on the mixers'
    and the shared block's shards moves no parameter's placement."""
    r = zamba_cells[0][shape]
    rules = JS.serve_rules(False) if shape.endswith("optimized") \
        else JS.baseline_rules(False)
    want = _jax_local_bytes("zamba2-2.7b", *MESHES["pod"], rules,
                            4 if shape == "train_4k" else 2)
    assert r["memory"]["param_bytes"] == pytest.approx(want, rel=1e-12)


RWKV_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(scope="module")
def rwkv_cells(tmp_path_factory):
    """rwkv6-7b's cells on the (16, 16) pod mesh (the serve cells also
    ``--optimized``), and on the (16, 1) mesh (the same rows a device, no
    model axis)."""
    out = tmp_path_factory.mktemp("rwkv6")
    pod = {s: dryrun.run_cell("rwkv6-7b", s, multi_pod=False, out_dir=out)
           for s in RWKV_SHAPES}
    pod.update({f"{s} optimized": dryrun.run_cell(
        "rwkv6-7b", s, multi_pod=False, out_dir=out, optimized=True)
        for s in RWKV_SHAPES[1:]})
    one = {s: dryrun.run_cell("rwkv6-7b", s, multi_pod=False, out_dir=out,
                              mesh=MeshShape((16, 1), ("data", "model")))
           for s in RWKV_SHAPES}
    return pod, one


@pytest.mark.parametrize("shape", list(RWKV_SHAPES) + [
    f"{s} optimized" for s in RWKV_SHAPES[1:]])
def test_rwkv6_layout_names_its_split(rwkv_cells, shape):
    """The layout field of rwkv6-7b's cells on (16, 16): the time-mix on 4
    of 64 WKV heads a rank and the channel-mix on its columns
    (``Cell.rwkv_split``), nothing guarded, the rows over the data axis
    alone (as on (16, 1)); on (16, 1) nothing splits."""
    r = rwkv_cells[0][shape]
    assert r["layout"]["rwkv_split"] == {"parts": ["pos0.tm", "pos0.cm"],
                                         "wkv_heads_per_rank": 4}
    assert r["layout"]["guarded"] == [] and r["layout"]["model_extent"] == 16
    flat = rwkv_cells[1][shape.split()[0]]
    assert r["rows_per_device"] == flat["rows_per_device"]
    assert flat["layout"]["rwkv_split"] == {"parts": [],
                                            "wkv_heads_per_rank": 0}


@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_rwkv6_wkv_count_is_a_rank_s_heads(shape):
    """The WKV scan's term of a device's operations on (16, 16) is a 16th
    of the (16, 1) mesh's, whose ranks scan all 64 heads: ``_per_token``'s
    scan term counts ``Hr / tp`` heads."""
    cell = TCells.build_cell("rwkv6-7b", shape, MeshShape(
        (16, 16), ("data", "model")))
    flat = TCells.build_cell("rwkv6-7b", shape, MeshShape(
        (16, 1), ("data", "model")))
    S = cell.shape.seq_len
    decode = cell.kind == "decode"
    lay, flay = (dryrun.layout(c, S) for c in (cell, flat))
    got, whole = (dryrun._per_token(cell.cfg, S, S, decode, 0.0, 2, x,
                                    True)[4:] for x in (lay, flay))
    assert lay.wkv_split == 16 and flay.wkv_split == 1
    assert got[0] * 16 == pytest.approx(whole[0], rel=1e-12)
    assert got[1] * 16 == pytest.approx(whole[1], rel=1e-12)


def test_rwkv6_cells_count_their_shards(rwkv_cells):
    """rwkv6-7b on (16, 16): the train cell under one card's 80e9 B (94.2e9
    while every rank computed whole), prefill_32k below 1e14 flop a
    device (9.26e14 while the model axis's ranks each ran their rows
    through the whole model), and decode under the serving rules moving
    no weight over ``model`` (below 1e8 B on the wire, 1.43e10 before);
    every cell under 80e9 B."""
    pod, _ = rwkv_cells
    assert pod["train_4k"]["memory"]["peak_per_device_bytes"] < 80e9
    assert pod["prefill_32k"]["cost"]["flops"] < 1e14
    assert pod["decode_32k optimized"]["cost"]["collective_wire_bytes"] \
        < 1e8
    for r in pod.values():
        assert r["memory"]["peak_per_device_bytes"] < 80e9, r["memory"]


def test_rwkv6_guard_when_a_rank_s_columns_cut_a_head():
    """On a model axis of 3 the rules leave d 4096 and 64 heads whole (3
    divides neither): no part splits and none is guarded. A d_model 48
    (3 heads of K 16) rwkv6 on 4 model ranks splits ``rwkv_hidden`` 12
    columns a rank, mid-head: its time-mix takes the guard
    (``"pos0.tm"``) while its channel-mix splits."""
    cell = TCells.build_cell("rwkv6-7b", "train_4k", MeshShape(
        (1, 3), ("data", "model")))
    assert cell.rwkv_split == () and cell.guarded == ()
    cfg = get_config("rwkv6-7b-smoke").replace(d_model=48)
    cell = TCells.build_cell(cfg, ShapeSpec("t", 16, 8, "train"), MeshShape(
        (1, 4), ("data", "model")))
    assert cell.guarded == ("pos0.tm",)
    assert cell.rwkv_split == ("pos0.cm",)


@pytest.mark.parametrize("shape", list(RWKV_SHAPES) + [
    f"{s} optimized" for s in RWKV_SHAPES[1:]])
def test_rwkv6_param_bytes_match_jax_shardings(rwkv_cells, shape,
                                               jax_specs):
    """A device's parameter bytes in rwkv6-7b's cells equal what the JAX
    package's ``param_shardings`` implies: computing on the time-mix's and
    channel-mix's shards moves no parameter's placement."""
    r = rwkv_cells[0][shape]
    rules = JS.serve_rules(False) if shape.endswith("optimized") \
        else JS.baseline_rules(False)
    want = _jax_local_bytes("rwkv6-7b", *MESHES["pod"], rules,
                            4 if shape == "train_4k" else 2)
    assert r["memory"]["param_bytes"] == pytest.approx(want, rel=1e-12)


# ------------------------------------------------ attention on head slots

MIDHEAD = ("starcoder2-7b", "qwen2-vl-7b", "llama4-maverick-400b-a17b")
#: the reference's per-device operations (its ``hlo_cost``) on the (16, 16)
#: pod mesh: ``JAX_PLATFORMS=cpu python -m repro.launch.dryrun --arch A
#: --shape S`` at commit c4dcef5 (llama3-8b, whose 32 heads split whole,
#: the control)
REF_FLOPS = {("starcoder2-7b", "train_4k"): 409197873741982.0,
             ("qwen2-vl-7b", "train_4k"): 349484306141926.0,
             ("llama4-maverick-400b-a17b", "train_4k"): 649291542208530.0,
             ("starcoder2-7b", "prefill_32k"): 381859944471813.0,
             ("llama3-8b", "train_4k"): 279975354984868.0}
#: how the reference lays out a head projection split over 16 model ranks,
#: read from its HLO (``--keep-hlo``, same commit): the head dim splits
#: over gcd(H, 16) ranks (starcoder2-7b 4, qwen2-vl-7b 4, llama4-maverick
#: 8), so a rank attends with H / gcd(H, 16) heads (9, 7, 5; each group
#: one KV head), its q columns all-gathered over the 16 / gcd ranks that
#: share them; its XLA attention computes every query against every key
#: (the causal half masked, not skipped), once forward, again in the
#: remat and twice in the backward
REF_ATTN_PASSES = {"train": 4, "prefill": 1}


@pytest.mark.parametrize("rules", ["baseline_rules", "sp_rules",
                                   "serve_rules"])
@pytest.mark.parametrize("arch", MIDHEAD)
def test_midhead_configs_take_no_guard(arch, rules):
    """On the (16, 16) pod mesh, in every shape and under every rule set,
    none of the mid-head configs lists a guarded part, none of their
    attention leaves is gathered over ``model``, and a rank attends on a
    head slot of ceil(H / 16) heads."""
    from repro_torch.distributed import sharding as SH
    cfg = get_config(arch)
    mesh = MeshShape(*MESHES["pod"])
    r = getattr(SH, rules)(False)
    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        cell = TCells.build_cell(arch, shape, mesh, rules=r)
        assert cell.guarded == (), shape.name
        for plan in TCells.leaf_plans(cfg, mesh, r,
                                      decode=shape.kind == "decode"):
            if "attn" in plan.path:
                assert 1 not in plan.upfront, (shape.name, plan.path)
        lay = dryrun.layout(cell, shape.seq_len)
        assert lay.heads == math.ceil(cfg.num_heads / 16)
        assert all(lay.attn.values())


@pytest.mark.parametrize("arch,shape", list(REF_FLOPS))
def test_flops_against_the_reference(arch, shape, tmp_path):
    """A device's operations against the reference's: never more (a rank
    attends with ceil(H / 16) heads and skips the causal half, where the
    reference's rank attends with H / gcd(H, 16) over every key); and
    within 10 % once the port's attention core is swapped for the
    reference's layout (``REF_ATTN_PASSES``), so every other term counts
    what the reference computes. The mid-head guard counted 1.3335e15,
    8.7825e14, 2.5657e15 and 8.7578e14 for the first four."""
    cfg = get_config(arch)
    r = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=tmp_path)
    ref = REF_FLOPS[(arch, shape)]
    kind, S = SHAPES[shape].kind, SHAPES[shape].seq_len
    tokens = r["rows_per_device"] * S
    layers = cfg.num_periods * (cfg.pattern.count("attn")
                                + cfg.pattern.count("attn_moe"))
    heads = cfg.num_heads // math.gcd(cfg.num_heads, 16)
    ref_core = tokens * layers * REF_ATTN_PASSES[kind] * 4 * heads \
        * cfg.head_dim * S
    got = r["cost"]["flops"]
    assert got <= ref, (got, ref)
    swapped = got - r["breakdown"]["attention_flops"] + ref_core
    assert abs(swapped - ref) <= 0.10 * ref, (swapped, ref)
    assert r["layout"]["guarded"] == []
    assert r["layout"]["q_heads_per_rank"] == math.ceil(cfg.num_heads / 16)


def test_maverick_train_peak_falls(tmp_path):
    """llama4-maverick ``train_4k`` on the pod mesh holds less than the
    65.91 GiB a device the guard's whole attention leaves took."""
    r = dryrun.run_cell("llama4-maverick-400b-a17b", "train_4k",
                        multi_pod=False, out_dir=tmp_path)
    assert r["memory"]["peak_per_device_bytes"] < 65.91 * 2**30


@pytest.mark.parametrize("arch", MIDHEAD[:2])
def test_midhead_optimized_decode_moves_no_weight(arch, tmp_path):
    """``decode_32k --optimized`` (weight-stationary, the distributed
    flash-decode): below 1e8 wire bytes a device (the guard gathered the
    attention leaves every call: 2.5619e9 and 1.3580e9), its q columns
    gathered instead of exchanged."""
    r = dryrun.run_cell(arch, "decode_32k", multi_pod=False,
                        out_dir=tmp_path, optimized=True)
    assert r["cost"]["collective_wire_bytes"] < 1e8, r["cost"]
    assert "all-to-all" not in r["cost"]["collectives"]
