"""chip_smoke.py's phase 14 (serving and scoring across devices) and its
dense-config phase rehearsed on the CPU at small sizes, through the plain
versions: the stats route and its shards recombined, the distributed
decode in a gloo world of one, the sharded fleets and rollout on a mesh
naming the CPU three times, and the dense smoke configs' prefill against
their f32 forward."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stats_phase_rehearsal(smoke):
    rec = smoke.stats_phase("cpu", [("qwen3", 3, 64, 8, 4, 32),
                                    ("dbrx", 2, 64, 12, 2, 16)],
                            time_it=False)
    assert rec["stats_bound_by"] == "bytes"
    assert 0 <= rec["stats_max_abs_err"] < 1e-3


def test_dist_decode_phase_rehearsal(smoke):
    import torch.distributed as dist
    rec = smoke.dist_decode_phase("cpu", "qwen3-1.7b-smoke", batch=2,
                                  max_seq=32, steps=2)
    assert not dist.is_initialized()         # the world was destroyed
    from repro_torch.configs import get_config
    # two timed steps after an untimed first, one stats launch a layer
    assert rec["launches"] == 3 * get_config("qwen3-1.7b-smoke").num_layers


def test_fleet_mesh_phase_rehearsal(smoke):
    from repro_torch.launch import mesh as mesh_mod
    before = mesh_mod.local_devices
    out = smoke.fleet_mesh_phase("cpu", n=4, rollout=dict(n=16, width=16))
    assert mesh_mod.local_devices is before
    assert set(out) == {"lr", "gam", "ann", "lstm", "rollout"}
    assert out["rollout"]["launches"] == 3 * smoke.HORIZON


def test_dense_gap_phase_rehearsal(smoke):
    out = smoke.dense_gap_phase("cpu", {"llama3-8b-smoke": 2,
                                        "qwen2-vl-7b-smoke": 2,
                                        "hubert-xlarge-smoke": 2})
    assert "serve" in out["llama3-8b-smoke"]
    assert "serve" not in out["hubert-xlarge-smoke"]


def test_kernel_line_keeps_the_stats_route(smoke):
    rows = {name: {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0,
                   "bound_ms": 0.5, "bound_by": "bytes"}
            for name in smoke.COUNT_NAMES}
    rows["decode_attention"].update(stats_ms=0.1, stats_bound_ms=0.05,
                                    stats_launches=28)
    line = smoke.kernel_line(rows, {n: 1 for n in smoke.COUNT_NAMES})
    assert len(line["kernels"]) == 8
    dec = next(r for r in line["kernels"] if r["name"] == "decode_attention")
    assert dec["stats_ms"] == 0.1 and dec["stats_launches"] == 28
