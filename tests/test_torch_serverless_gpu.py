"""Durability and spawned serverless workers on the card. Imports no JAX,
so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serverless_gpu.py

* A version trained on the card is journaled; ``Castor.open`` of the log
  on the card scores through ``fleet_mlp`` (24 launches, one per horizon
  step) to the uninterrupted system's forecasts, bitwise; on the CPU the
  same log recovers the same version bytes.
* One ``ProcessBackend`` child builds ``Castor(device="cuda")``, loads the
  kernels the parent built and runs an ANN score bin on its own card.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.castor import Castor
from repro_torch.durability.chaos import clone_to_memory
from repro_torch.forecast import ANNForecaster, version_to_numpy
from repro_torch.kernels.fleet_mlp import kernel as fleet_mlp_kernel
from repro_torch.kernels.fleet_mlp import ops as fleet_mlp_ops
from repro_torch.serverless import (InMemoryStorage, ProcessBackend,
                                    ServerlessExecutor)
from repro_torch.testing import (FLEET_ATOL, FLEET_NOW, FLEET_RTOL, HOUR,
                                 assert_stores_bitwise_equal,
                                 build_steady_castor, drive_plan,
                                 snapshot_stores, steady_plan)

HP = {"hidden": 64, "epochs": 30}
N = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    fleet_mlp_kernel.build()
    return "cuda"


@pytest.mark.gpu
def test_version_trained_on_card_recovers_and_scores_bitwise(cuda_device):
    plan = steady_plan("ann", ANNForecaster, HP, n=N, polls=2,
                       device=cuda_device)
    storage = InMemoryStorage()
    live = Castor.open(storage=storage, device=cuda_device)
    drive_plan(live, plan, boundaries=plan["boundaries"][:1])
    live.journal.barrier()
    dead = clone_to_memory(storage)
    assert all(r.ok for r in live.tick(plan["boundaries"][1]))
    want = snapshot_stores(live)                 # the uninterrupted run

    got = Castor.open(storage=dead, device=cuda_device)
    mv = got.versions.get("s-Z_PRO_0_0")
    assert mv.params["params"]["w0"].device.type == cuda_device
    fleet_mlp_ops.reset_invocation_count()
    drive_plan(got, plan)                        # scores the 2nd boundary
    assert fleet_mlp_ops.invocation_count() == 24
    assert_stores_bitwise_equal(want, got, context="recovered on card")

    cpu = Castor.open(storage=clone_to_memory(dead), device="cpu")
    for name in live.versions.model_ids():
        a = version_to_numpy(cpu.versions.get(name).params)
        b = version_to_numpy(live.versions.get(name).params)
        for k, v in b["params"].items():
            assert a["params"][k].tobytes() == v.tobytes(), k
        assert cpu.versions.get(name).params["mu"].device.type == "cpu"
    drive_plan(cpu, plan)
    for name in live.versions.model_ids():
        fc = cpu.predictions.history(name)[-1]
        want_fc = live.predictions.history(name)[-1]
        assert fc.created_at == want_fc.created_at
        np.testing.assert_allclose(fc.values, want_fc.values,
                                   rtol=FLEET_RTOL, atol=FLEET_ATOL)
    for c in (live, got, cpu):
        c.close()


@pytest.mark.gpu
def test_spawned_worker_runs_an_ann_score_bin_on_its_card(cuda_device):
    factory = functools.partial(build_steady_castor, "ann", ANNForecaster,
                                HP, n=N, device=cuda_device)
    c = factory()
    ref = factory()
    ex = ServerlessExecutor(c, backend=ProcessBackend(
        factory, n_workers=1, spawn_timeout_s=300.0,
        invoke_timeout_s=300.0), speculative=False)
    mark = c.tracer.mark()
    try:
        res = ex.run(c.scheduler.poll(FLEET_NOW))
        assert res and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
        assert all(r.ok for r in ref.tick(FLEET_NOW))
        spans = [sp for sp in c.tracer.export_since(mark)
                 if sp["name"] == "worker.execute"]
        assert [sp["args"]["device"] for sp in spans] == [cuda_device] * 2
        assert spans[-1]["args"]["fleet_mlp_launches"] == 24
        for i in range(N):
            name = f"s-Z_PRO_0_{i}"
            mv = c.versions.get(name)
            assert mv.params["params"]["w0"].device.type == cuda_device
            fc, want = (x.predictions.history(name)[-1] for x in (c, ref))
            np.testing.assert_allclose(fc.values, want.values,
                                       rtol=FLEET_RTOL, atol=FLEET_ATOL)
        fleet_mlp_ops.reset_invocation_count()
        assert all(r.ok for r in
                   c.tick(FLEET_NOW + HOUR, executor="fleet"))
        assert fleet_mlp_ops.invocation_count() == 24
    finally:
        ex.close()
