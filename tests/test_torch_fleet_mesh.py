"""The port's fleet-bin sharding on the CPU: ``fleet_sharded`` against the
unsharded call, and whole bins of the four forecasters sharded over a mesh
of 3 CPU devices (``launch.mesh.local_devices`` patched) against the same
bins on one device, at the tolerances of ``tests/test_fleet_mesh.py``:
versions rtol 5e-2 / atol 5e-3, forecasts ``FLEET_RTOL`` / ``FLEET_ATOL``.
The telemetry and the opt-outs as the JAX package's executor reports
them."""
import numpy as np
import pytest
import torch

from repro_torch.core.executor import FleetExecutor
from repro_torch.distributed.sharding import fleet_sharded
from repro_torch.forecast import (ANNForecaster, GAMForecaster,
                                  LSTMForecaster, LinearForecaster)
from repro_torch.kernels.fleet_mlp import ops as fleet_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.testing import (FLEET_ATOL, FLEET_NOW as NOW, FLEET_RTOL,
                                 build_fleet_castor)

torch.set_num_threads(2)

MODELS = {
    "lr": (LinearForecaster, {}),
    "gam": (GAMForecaster, {}),
    "ann": (ANNForecaster, {"hidden": 8, "epochs": 20}),
    "lstm": (LSTMForecaster, {"hidden": 8, "epochs": 20}),
}
CPU3 = (torch.device("cpu"),) * 3


@pytest.fixture
def three_devices(monkeypatch):
    """The mesh module sees 3 devices (all the CPU): bins of 2 or more
    jobs shard over min(3, bin) of them."""
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: CPU3)


def _fleet_castor(kind, mesh_opt, n=6):
    cls, hp = MODELS[kind]
    return build_fleet_castor(kind, cls, hp, mesh_opt, n=n, device="cpu")


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("n", [4, 7, 8])
def test_fleet_sharded_pads_replicates_and_slices_back(n):
    mesh = mesh_mod.make_fleet_mesh(devices=CPU3)
    seen = []

    def fn(x, p, scale):        # x, p sharded; scale replicated
        seen.append(x.shape[0])
        return {"out": x * scale + p["b"][:, None], "sum": x.sum(dim=-1)}

    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    p = {"b": torch.arange(n, dtype=torch.float32)}
    scale = torch.tensor(2.0)
    got = fleet_sharded(fn, mesh, replicated_argnums=(2,))(x, p, scale)
    want = {"out": x * scale + p["b"][:, None], "sum": x.sum(dim=-1)}
    assert seen == [-(-n // 3)] * 3         # the padded axis, cut in three
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pad_replicates_the_last_row_never_zeros():
    mesh = mesh_mod.make_fleet_mesh(devices=CPU3)
    knots = torch.tensor([[0.0, 1.0, 2.0], [1.0, 2.0, 5.0]])   # n = 2, pad 1
    rows = []
    fleet_sharded(lambda k: rows.append(k) or k, mesh)(knots)
    assert torch.equal(rows[-1], knots[-1:])
    assert all(bool((torch.diff(r, dim=-1) > 0).all()) for r in rows)


def test_make_fleet_mesh_sizes_and_memoises():
    assert mesh_mod.make_fleet_mesh(devices=CPU3[:1]) is None
    assert mesh_mod.make_fleet_mesh(1, devices=CPU3) is None
    m2 = mesh_mod.make_fleet_mesh(2, devices=CPU3)
    assert m2.devices == CPU3[:2] and m2.shape == (2,)
    assert m2.mesh_dim_names == (mesh_mod.FLEET_AXIS,)
    assert mesh_mod.make_fleet_mesh(2, devices=CPU3) is m2
    with pytest.raises(ValueError, match="needs 4"):
        mesh_mod.make_fleet_mesh(4, devices=CPU3)
    assert mesh_mod.dp_axes(m2) == ()


@pytest.mark.parametrize("kind", list(MODELS))
def test_sharded_equals_unsharded_fleet(kind, three_devices):
    """The mesh-sharded fleet path persists the same model versions and
    forecasts as the whole bin on one device, and reports one fleet call
    per bin over a mesh sized to the bin."""
    fleet_ops.reset_invocation_count()
    ca, fa = _fleet_castor(kind, "auto")
    launches = fleet_ops.invocation_count()
    cb, fb = _fleet_castor(kind, "off")
    assert len(fa.last_bin_stats) == 2               # train, then score
    for b in fa.last_bin_stats:
        assert b["sharded"] and b["mesh_devices"] == 3
        assert b["pad"] == (-6) % 3
        assert b["dispatches"] == 1
    assert all(not b["sharded"] and b["mesh_devices"] == 1 and b["pad"] == 0
               for b in fb.last_bin_stats)
    if kind == "ann":       # the score rollout: once per shard per step
        assert launches == 3 * 24
    for i in range(6):
        name = f"s-Z_PRO_0_{i}"
        pa = ca.versions.get(name).params["params"]
        pb = cb.versions.get(name).params["params"]
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_allclose(_np(pa[k]), _np(pb[k]), rtol=5e-2,
                                       atol=5e-3, err_msg=f"{kind} {k}")
        fca = ca.predictions.history(name)
        fcb = cb.predictions.history(name)
        assert len(fca) == len(fcb) == 1
        np.testing.assert_allclose(fca[0].times, fcb[0].times)
        np.testing.assert_allclose(fca[0].values, fcb[0].values,
                                   rtol=FLEET_RTOL, atol=FLEET_ATOL,
                                   err_msg=kind)
        np.testing.assert_allclose(fca[0].lower, fcb[0].lower,
                                   rtol=FLEET_RTOL, atol=FLEET_ATOL)


def test_uneven_bin_pads_and_matches(three_devices):
    """7 jobs over 3 devices: pad 2, the pad rows never reach a version."""
    ca, fa = _fleet_castor("ann", "auto", n=7)
    cb, _ = _fleet_castor("ann", "off", n=7)
    assert all(b["sharded"] and b["mesh_devices"] == 3 and b["pad"] == 2
               for b in fa.last_bin_stats)
    for i in range(7):
        name = f"s-Z_PRO_0_{i}"
        np.testing.assert_allclose(
            ca.predictions.history(name)[0].values,
            cb.predictions.history(name)[0].values,
            rtol=FLEET_RTOL, atol=FLEET_ATOL)


def test_mesh_off_opt_out_via_user_params(three_devices):
    _, fx = _fleet_castor("lr", "off", n=3)
    assert all(not b["sharded"] for b in fx.last_bin_stats)


def test_executor_level_mesh_off(three_devices):
    c, _ = _fleet_castor("lr", "auto", n=3)
    fx = FleetExecutor(c, mesh="off")
    res = fx.run(c.scheduler.poll(NOW + 1e12))
    assert res and all(r.ok for r in res)
    assert all(not b["sharded"] for b in fx.last_bin_stats)


def test_one_job_bin_and_one_device_decline_the_mesh(three_devices,
                                                     monkeypatch):
    _, fx = _fleet_castor("lr", "auto", n=1)
    assert all(not b["sharded"] and b["mesh_devices"] == 1
               for b in fx.last_bin_stats)
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: CPU3[:1])
    _, fx = _fleet_castor("lr", "auto", n=3)
    assert all(not b["sharded"] and b["pad"] == 0 for b in fx.last_bin_stats)


def test_two_job_bin_shards_over_two(three_devices):
    _, fx = _fleet_castor("lr", "auto", n=2)
    assert all(b["sharded"] and b["mesh_devices"] == 2 and b["pad"] == 0
               for b in fx.last_bin_stats)
