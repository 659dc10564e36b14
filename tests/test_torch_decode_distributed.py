"""The port's distributed flash-decode on the CPU: the stats route's plain
version against the JAX package's ``_partial`` at the same offsets, the
combine of shards on one device, and ``decode_attention_distributed`` in
one gloo world of 4 processes over meshes (1, 2), (2, 2) and (1, 4) against
the JAX package's ``decode_attention_distributed`` (run once, in a
subprocess with 8 forced host devices, as tests/test_elastic_restore.py
does) and against the port's one-device ``decode_attention``. Then
``decode_step(attn_dist=...)`` of qwen3-1.7b-smoke and dbrx-132b-smoke on
the (1, 2) mesh against the undistributed step. Tolerances are
tests/test_torch_lm.py's: f32 2e-5, bf16 2e-2, on |got - want| / (1 +
|want|) for attention outputs and relative to the largest logit for
logits."""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import decode_world, run_world
from repro.kernels.decode_attention.distributed import _partial as jax_partial
from repro_torch.kernels.decode_attention import distributed as tdist
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_partial)
from repro_torch.kernels.decode_attention.ref import NEG_INF

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SRC = Path(__file__).resolve().parents[1] / "src"

# (label, mesh (data, model), B, S, H, KV, D, lengths): GQA groups 1, 2, 6
# and 8; a length-0 row; rows that end inside the first shard; B = 3 over a
# data extent of 2 (kept replicated); S_loc = 32 on the (1, 4) mesh
SHAPES = [
    ("g1", (1, 2), 3, 64, 8, 8, 32, [0, 10, 64]),
    ("g2", (2, 2), 4, 128, 4, 2, 64, [0, 5, 70, 128]),
    ("g6-b3", (2, 2), 3, 128, 12, 2, 64, [1, 40, 128]),
    ("g8-sloc32", (1, 4), 2, 128, 16, 2, 32, [7, 100]),
]
DTYPES = ["float32", "bfloat16"]
LM_CASES = [dict(arch="qwen3-1.7b-smoke", lengths=[5, 40], seed=3, S=64),
            dict(arch="dbrx-132b-smoke", lengths=[31, 32], seed=4, S=64)]


def _as_dtype(a: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values the dtype represents exactly (bf16 has no numpy type)."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _cases() -> list:
    out = []
    for seed, (label, mesh, B, S, H, KV, D, lengths) in enumerate(SHAPES):
        rng = np.random.default_rng(seed)
        for dtype in DTYPES:
            q, k, v = (_as_dtype(rng.normal(size=s).astype(np.float32), dtype)
                       for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
            out.append(dict(label=f"{label}-{dtype}", mesh=mesh, dtype=dtype,
                            q=q, k=k, v=v,
                            lengths=np.asarray(lengths, np.int32)))
    return out


CASES = _cases()
LABELS = [c["label"] for c in CASES]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.kernels.decode_attention.distributed import (
        decode_attention_distributed)
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    assert jax.device_count() == 8
    out = {}
    for c in cases:
        n = c["mesh"][0] * c["mesh"][1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(c["mesh"]),
                    ("data", "model"))
        dt = jnp.dtype(c["dtype"])
        # under jit: one compiled program, not op-by-op dispatch
        run = jax.jit(lambda *a, mesh=mesh: decode_attention_distributed(
            *a, mesh=mesh))
        o = run(jnp.asarray(c["q"], dt), jnp.asarray(c["k"], dt),
                jnp.asarray(c["v"], dt), jnp.asarray(c["lengths"]))
        out[c["label"]] = np.asarray(o.astype(jnp.float32))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's outputs, computed in a subprocess started before
    the gloo world so that the two run side by side."""
    d = tmp_path_factory.mktemp("jax")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(CASES, f)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "cases.pkl"),
         str(d / "out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             # without it jax probes for accelerator plugins
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    """One gloo world of 4 for the module: each rank's results."""
    return run_world(decode_world, 4, tmp_path_factory.mktemp("decode"),
                     CASES, LM_CASES, timeout=240)


@pytest.fixture(scope="module")
def jax_outputs(jax_run):
    proc, d = jax_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _torch_inputs(c):
    dt = getattr(torch, c["dtype"])
    return (*(torch.from_numpy(c[n]).to(dt) for n in ("q", "k", "v")),
            torch.from_numpy(c["lengths"]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 32, 64, 96])
def test_partial_matches_reference_at_offset(dtype, offset):
    """The port's ``_partial`` (the stats route's plain version on the local
    lengths) against the reference's ``_partial`` on one 32-slot chunk."""
    c = next(c for c in CASES if c["label"] == f"g8-sloc32-{dtype}")
    q, k, v, lengths = _torch_inputs(c)
    k, v = (t[:, offset:offset + 32] for t in (k, v))
    got = tdist._partial(q, k, v, lengths, offset)
    jdt = jnp.dtype(dtype)
    want = jax_partial(jnp.asarray(c["q"], jdt),
                       jnp.asarray(c["k"][:, offset:offset + 32], jdt),
                       jnp.asarray(c["v"][:, offset:offset + 32], jdt),
                       jnp.asarray(c["lengths"]), offset)
    for name, g, w in zip("oml", got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), np.asarray(w)) <= TOL[dtype], name


def test_empty_ranges_give_no_nan():
    """A length-0 row, and a shard past every length: m = -1e30, l = 0,
    o = 0, and the combine over shards gives zeros, never NaN."""
    c = next(c for c in CASES if c["label"] == "g1-float32")
    q, k, v, _ = _torch_inputs(c)
    lengths = torch.tensor([0, 10, 20], dtype=torch.int32)
    parts = [tdist._partial(q, k[:, i:i + 32], v[:, i:i + 32], lengths, i)
             for i in (0, 32)]
    o, m, l = parts[1]                       # past every length
    assert bool((m == NEG_INF).all()) and bool((l == 0).all())
    assert bool((o == 0).all())
    out = tdist.combine_partials(*(torch.stack(t) for t in zip(*parts)))
    assert not bool(torch.isnan(out).any())
    assert bool((out[0] == 0).all())
    want = decode_attention(q, k, v, lengths)
    assert _rel(out[1:].numpy(), want[1:].numpy()) <= TOL["float32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_combine_of_stacked_shards_equals_one_call(dtype, n_shards):
    c = next(c for c in CASES if c["label"] == f"g2-{dtype}")
    q, k, v, lengths = _torch_inputs(c)
    S_loc = k.shape[1] // n_shards
    parts = [tdist._partial(q, k[:, i * S_loc:(i + 1) * S_loc],
                            v[:, i * S_loc:(i + 1) * S_loc], lengths,
                            i * S_loc) for i in range(n_shards)]
    got = tdist.combine_partials(*(torch.stack(t) for t in zip(*parts)))
    o, m, l = decode_attention_partial(q, k, v, lengths)
    one = o / torch.clamp_min(l, 1e-30)[..., None]
    # each shard rounds its p (relative to its own max) to the cache dtype
    assert _rel(got.numpy(), one.numpy()) <= TOL[dtype]
    want = decode_attention(q, k, v, lengths)
    live = lengths > 0
    assert _rel(got[live].to(q.dtype).float().numpy(),
                want[live].float().numpy()) <= TOL[dtype]


@pytest.mark.parametrize("label", LABELS)
def test_distributed_matches_jax(label, world, jax_outputs):
    got = world[0][label]["out"].numpy()
    assert not np.isnan(got).any()
    dtype = label.rsplit("-", 1)[1]
    assert _rel(got, jax_outputs[label]) <= TOL[dtype]


@pytest.mark.parametrize("label", LABELS)
def test_distributed_matches_one_device(label, world):
    c = CASES[LABELS.index(label)]
    q, k, v, lengths = _torch_inputs(c)
    got = world[0][label]["out"]
    want = decode_attention(q, k, v, lengths)
    live = lengths > 0
    assert _rel(got[live].numpy(), want[live].float().numpy()) \
        <= TOL[c["dtype"]]
    assert bool((got[~live] == 0).all())       # a length-0 row: zeros


@pytest.mark.parametrize("label", LABELS)
def test_output_rows_follow_the_batch_rule(label, world):
    """B on the data axis where it divides the extent, else replicated."""
    c = CASES[LABELS.index(label)]
    rec = world[0][label]
    B, data = c["q"].shape[0], c["mesh"][0]
    sharded = B % data == 0
    assert rec["local_rows"] == (B // data if sharded else B)
    assert rec["placements"] == (("S(0)" if sharded else "R"), "R")


@pytest.mark.parametrize("arch", [c["arch"] for c in LM_CASES])
def test_decode_step_with_attn_dist_matches_undistributed(arch, world):
    r0, r1 = world[0][arch], world[1][arch]
    want = r0["want"]
    for r in (r0, r1):
        err = float((r["logits"] - want).abs().max()
                    / want.abs().max())
        assert err <= TOL["float32"], err
    assert torch.equal(r0["lengths"],
                       torch.tensor(LM_CASES[0]["lengths"] if arch.startswith(
                           "qwen") else LM_CASES[1]["lengths"]) + 1)
    # the new k/v landed in the chunk that holds each position, nowhere
    # else: the first period's (from the embeddings alone) bit for bit, the
    # later ones' through hidden states that the distributed attention
    # rounded in another order
    for key, leaves in r0["whole"].items():
        for name, whole in leaves.items():
            cat = torch.cat([r0["chunks"][key][name],
                             r1["chunks"][key][name]], dim=2)
            assert torch.equal(cat[0], whole[0]), (key, name)
            torch.testing.assert_close(cat, whole, rtol=TOL["float32"],
                                       atol=TOL["float32"])
