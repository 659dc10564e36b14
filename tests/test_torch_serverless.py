"""The port's serverless subsystem (``repro_torch.serverless``) on the CPU.

* Against the JAX package: the inline executor with storage-mediated
  payloads and results persists the JAX package's forecasts on the same
  steady plan (LR; ANN from the JAX package's initial weights), at
  FLEET_RTOL/ATOL, with the same invocation plan.
* Against the port's own fleet executor: bitwise, for all four
  forecasters (bins are never split, and each worker runs the fleet path).
* Twins of ``tests/test_serverless.py`` and
  ``tests/test_serverless_chaos.py``: aggregation, sticky affinity,
  retries, idempotent duplicates, partial bins, payload round trips (a
  model object of tensors crosses as its numpy image), every seeded chaos
  fault bitwise equal to the fault-free run, the object stores, futures,
  the autoscaler, and spawned ``ProcessBackend`` workers (each builds
  ``Castor(device="cpu")`` from a picklable factory; each spawn has a
  cold-start and an invocation timeout).
"""
import functools
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _property_settings import UNTIMED
from repro.forecast import ANNForecaster as JaxANN
from repro.forecast import LinearForecaster as JaxLR
from repro.serverless import InMemoryStorage as JaxMemory
from repro.serverless import ServerlessExecutor as JaxServerlessExecutor
from repro.testing import build_steady_castor as jax_build_steady_castor
from repro_torch.core import ModelDeployment, Schedule
from repro_torch.forecast import (ANNForecaster, GAMForecaster,
                                  LSTMForecaster, LinearForecaster,
                                  version_to_numpy)
from repro_torch.kernels.fleet_mlp import ops as fleet_mlp_ops
from repro_torch.serverless import (ALWAYS, ANY_COMPLETED, AutoscalePolicy,
                                    Autoscaler, ChaosPolicy,
                                    FilesystemStorage, FuturesTimeoutError,
                                    InlineBackend, InMemoryStorage,
                                    InvocationMonitor, InvocationPayload,
                                    ProcessBackend, ResponseFuture,
                                    ServerlessExecutor, StorageKeyError,
                                    wait)
from repro_torch.serverless.backend import InvocationError
from repro_torch.serverless.payload import (ForecastBlob, InvocationResult,
                                            JobOutcome, JobRef, VersionRef)
from repro_torch.serverless.storage import (get_payload, get_result,
                                            payload_key, put_payload,
                                            put_result)
from repro_torch.testing import (FLEET_ATOL, FLEET_NOW as NOW, FLEET_RTOL,
                                 HOUR, assert_stores_bitwise_equal,
                                 build_steady_castor, snapshot_stores)
from test_torch_train import jax_initial_weights

torch.set_num_threads(1)

MODELS = {
    "lr": (LinearForecaster, {}),
    "gam": (GAMForecaster, {}),
    "ann": (ANNForecaster, {"hidden": 16, "epochs": 30}),
    "lstm": (LSTMForecaster, {"hidden": 8, "epochs": 30}),
}
CHAOS_MODELS = {
    "lr": (LinearForecaster, {}),
    "gam": (GAMForecaster, {}),
    "ann": (ANNForecaster, {"hidden": 8, "epochs": 10}),
    "lstm": (LSTMForecaster, {"hidden": 4, "epochs": 10}),
}
POLLS = 3
N = 3
#: every spawned worker must come up, and answer, within these
SPAWN_TIMEOUT_S = 120.0
INVOKE_TIMEOUT_S = 120.0


def _steady(kind, cls, hp, n=4):
    return build_steady_castor(kind, cls, hp, n=n, device="cpu")


def _lr(n):
    return _steady("lr", LinearForecaster, {}, n=n)


# ------------------------------------------------ against the JAX package

JAX_TWINS = {"lr": (JaxLR, LinearForecaster, {}),
             "ann": (JaxANN, ANNForecaster, {"hidden": 8, "epochs": 20})}


@pytest.mark.parametrize("kind", list(JAX_TWINS))
def test_serverless_matches_jax_serverless(kind):
    """The same steady plan through both packages' inline serverless
    executors, payloads and results round-tripping an object store: the
    same invocation plan, and forecasts and bands at FLEET_RTOL/ATOL."""
    jcls, cls, hp = JAX_TWINS[kind]
    jc = jax_build_steady_castor(kind, jcls, hp, n=4)
    tc = _steady(kind, cls, hp)
    jex = JaxServerlessExecutor(jc, n_workers=2, storage=JaxMemory(),
                                speculative=False)
    tex = ServerlessExecutor(tc, n_workers=2, storage=InMemoryStorage(),
                             speculative=False)
    jc._serverless_ex, tc._serverless_ex = jex, tex
    with jax_initial_weights(fleet=True):
        for k in range(POLLS):
            jres = jc.tick(NOW + k * HOUR, executor="serverless")
            tres = tc.tick(NOW + k * HOUR, executor="serverless")
            assert jres and all(r.ok for r in jres + tres), \
                [r.error for r in jres + tres if not r.ok]
            assert len(jres) == len(tres)
    for i in range(4):
        want = jc.predictions.history(f"s-Z_PRO_0_{i}")
        got = tc.predictions.history(f"s-Z_PRO_0_{i}")
        assert [f.created_at for f in got] == [f.created_at for f in want]
        assert len(got) == POLLS
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.times, w.times)
            assert g.model_version == w.model_version
            for a, b in ((g.values, w.values), (g.lower, w.lower),
                         (g.upper, w.upper)):
                np.testing.assert_allclose(a, b, rtol=FLEET_RTOL,
                                           atol=FLEET_ATOL)
    plan = [(r["jobs"], r["bins"], r["cold"]) for r in tex.monitor.records]
    assert plan == [(r["jobs"], r["bins"], r["cold"])
                    for r in jex.monitor.records]
    assert tex.stats()["storage"]["puts"] == jex.stats()["storage"]["puts"]


# ------------------------------------------------ against the fleet path


@pytest.mark.parametrize("kind", list(MODELS))
def test_inline_serverless_equals_fleet_bitwise(kind):
    """tick(executor="serverless") with the inline backend, payloads and
    results through an object store, persists exactly the fleet
    executor's versions and forecasts, over a train poll and warm score
    polls."""
    cls, hp = MODELS[kind]
    ca = _steady(kind, cls, hp)
    cb = _steady(kind, cls, hp)
    cb._serverless_ex = ServerlessExecutor(cb, storage=InMemoryStorage())
    for k in range(POLLS):
        ra = ca.tick(NOW + k * HOUR, executor="fleet")
        rb = cb.tick(NOW + k * HOUR, executor="serverless")
        assert ra and all(r.ok for r in ra + rb), \
            [r.error for r in ra + rb if not r.ok]
    assert_stores_bitwise_equal(ca, cb, context=f"{kind} serverless")
    for i in range(4):
        assert len(cb.predictions.history(f"s-Z_PRO_0_{i}")) == POLLS
    s = cb.stats()["serverless"]
    assert s["invocations"] >= POLLS
    assert s["cold_starts"] >= 1 and s["warm_starts"] >= POLLS - 1


def test_bins_stay_whole_across_invocations():
    c = _lr(6)
    ex = ServerlessExecutor(c, n_workers=2, aggregation=12,
                            speculative=False)
    c._serverless_ex = ex
    res = ex.run(c.scheduler.poll(NOW))
    assert all(r.ok for r in res)
    res = ex.run(c.scheduler.poll(NOW + 3 * HOUR))
    assert len(res) == 18 and all(r.ok for r in res), \
        [r.error for r in res if not r.ok]
    recs = ex.monitor.records
    assert all(r["jobs"] % 6 == 0 for r in recs), recs
    assert any(r["jobs"] == 12 and r["bins"] == 2 for r in recs), recs
    assert [f.created_at for f in c.predictions.history("s-Z_PRO_0_0")] \
        == [NOW + k * HOUR for k in range(4)]
    for f in c.predictions.history("s-Z_PRO_0_0"):
        assert f.times[0] == f.created_at


def test_sticky_affinity_keeps_bins_on_one_warm_worker():
    polls = 4
    c = _lr(4)
    ex = ServerlessExecutor(c, n_workers=3, speculative=False)
    c._serverless_ex = ex
    for k in range(polls):
        res = ex.run(c.scheduler.poll(NOW + k * HOUR))
        assert res and all(r.ok for r in res)
    workers = {r["worker"] for r in ex.monitor.records}
    assert len(workers) == 1
    s = ex.stats()
    assert s["cold_starts"] == 1
    assert s["warm_starts"] == s["invocations"] - 1
    (w,) = [ex.backend._workers[w] for w in workers]
    assert w.executor.runtime.warm_loads >= polls - 2
    assert w.executor.runtime.cold_loads == 1


class _FlakyBackend(InlineBackend):
    """Fails each invocation's first delivery at the backend level."""

    def __init__(self, system, *, n_workers=2, fail_first=1):
        super().__init__(system, n_workers=n_workers)
        self.fail_first = fail_first
        self.seen = {}
        self._seen_lock = threading.Lock()

    def invoke(self, payload, worker_id):
        with self._seen_lock:
            n = self.seen.get(payload.invocation_id, 0)
            self.seen[payload.invocation_id] = n + 1
        if n < self.fail_first:
            raise InvocationError("transient backend failure")
        return super().invoke(payload, worker_id)


def test_invoker_retries_with_backoff_exactly_once_effects():
    c = _lr(4)
    ex = ServerlessExecutor(c, backend=_FlakyBackend(c, n_workers=2),
                            max_retries=2, backoff_base_s=0.01,
                            speculative=False)
    res = ex.run(c.scheduler.poll(NOW))
    assert res and all(r.ok for r in res), \
        [r.error for r in res if not r.ok]
    s = ex.stats()
    assert s["retries"] >= 1 and s["failed_invocations"] >= 1
    for i in range(4):
        assert len(c.predictions.history(f"s-Z_PRO_0_{i}")) == 1
        assert len(c.versions.history(f"s-Z_PRO_0_{i}")) == 1
    assert not c.scheduler.poll(NOW + 1.0)


def test_invoker_exhausted_retries_fail_and_requeue():
    c = _lr(2)
    ex = ServerlessExecutor(c, backend=_FlakyBackend(c, n_workers=2,
                                                     fail_first=99),
                            max_retries=1, backoff_base_s=0.01,
                            speculative=False)
    res = ex.run(c.scheduler.poll(NOW))
    assert res and not any(r.ok for r in res)
    refire = c.scheduler.poll(NOW + 1.0)
    assert sorted({j.task for j in refire}) == ["score", "train"]
    assert all(j.scheduled_at == NOW for j in refire)


def test_duplicate_invocation_is_idempotent():
    c = _lr(3)
    ex = ServerlessExecutor(c, n_workers=2, speculative=False)
    res = ex.run(c.scheduler.poll(NOW))
    assert all(r.ok for r in res)
    backend = ex.backend
    jobs = c.scheduler.poll(NOW + HOUR)
    refs = tuple(JobRef.from_job(j) for j in jobs)
    payload = InvocationPayload(invocation_id="dup-1", jobs=refs)
    r1 = backend.invoke(payload, "w0")
    r2 = backend.invoke(payload, "w1")
    assert all(o.ok for o in r1.outcomes + r2.outcomes)
    for i in range(3):
        assert len(c.predictions.history(f"s-Z_PRO_0_{i}")) == 2


def test_missing_version_fails_alone():
    c = _lr(4)
    c.deploy(ModelDeployment(
        name="cold", package="lr", signal="ENERGY_LOAD",
        entity="Z_PRO_0_0", train=None, score=Schedule(NOW, 1e12),
        user_params={"train_window_days": 14}))
    ex = ServerlessExecutor(c, n_workers=2, speculative=False)
    res = ex.run(c.scheduler.poll(NOW))
    by_name = {r.job.deployment_name: r for r in res
               if r.job.task == "score"}
    assert not by_name["cold"].ok
    assert "no trained version" in by_name["cold"].error
    assert all(r.ok for n, r in by_name.items() if n != "cold")
    refire = c.scheduler.poll(NOW + 1.0)
    assert [j.deployment_name for j in refire] == ["cold"]


# ------------------------------------------------------------ payloads


def test_payload_and_result_roundtrip_json_bitwise():
    job = JobRef("d0", "lr", "1.0", "score", NOW, "ENERGY_LOAD", "E0",
                 "params-key")
    arrs = {"w": np.linspace(-1, 1, 7).astype(np.float32),
            "b": np.arange(4, dtype=np.float64) * np.pi}
    vr = VersionRef("d0", 3, NOW - HOUR,
                    model_object={"kind": "lr", "params": arrs,
                                  "y_scale": 2.5})
    p = InvocationPayload(invocation_id="inv-1", jobs=(job,),
                          versions=(vr,), created_at=123.25, attempt=2)
    q = InvocationPayload.from_json(p.to_json())
    assert q.jobs == (job,)
    assert q.invocation_id == "inv-1" and q.attempt == 2
    mo = q.versions[0].model_object
    for k, v in arrs.items():
        got = mo["params"][k]
        assert got.dtype == v.dtype and np.array_equal(got, v)
    assert mo["y_scale"] == 2.5
    assert q.jobs[0].to_job().bin_key == job.to_job().bin_key


def test_payload_carries_a_model_object_as_its_numpy_image():
    """A version held as tensors crosses the wire as its numpy image,
    bitwise, and the same payload holding that image encodes identically."""
    c = _steady("ann", ANNForecaster, {"hidden": 8, "epochs": 5}, n=2)
    assert all(r.ok for r in c.tick(NOW))
    mv = c.versions.get("s-Z_PRO_0_0")
    job = JobRef.from_job(c.scheduler.poll(NOW + HOUR)[0])
    image = version_to_numpy(mv.params)

    def payload(mo):
        return InvocationPayload(invocation_id="inv-t", jobs=(job,),
                                 versions=(VersionRef(
                                     "s-Z_PRO_0_0", mv.version,
                                     mv.trained_at, model_object=mo),))

    s = payload(mv.params).to_json()
    assert s == payload(image).to_json()
    back = InvocationPayload.from_json(s).versions[0].model_object
    for k, v in image["params"].items():
        assert back["params"][k].dtype == v.dtype
        assert back["params"][k].tobytes() == v.tobytes()


# ------------------------------------------------ chaos equivalence

#: each scenario fires on EVERY invocation's first delivery (prob 1.0,
#: max_attempt 1) — the retry is clean, so convergence is forced to go
#: through the fault path, never around it
CHAOS = {
    "kill": dict(seed=11, kill_mid_action=1.0),
    "drop": dict(seed=12, drop_result=1.0),
    "duplicate": dict(seed=13, duplicate=1.0),
    "delay": dict(seed=14, delay=1.0, delay_s=0.02),
}
_BASELINES = {}


def _run_polls(kind, chaos):
    cls, hp = CHAOS_MODELS[kind]
    c = build_steady_castor(kind, cls, hp, n=N, device="cpu")
    ex = ServerlessExecutor(c, n_workers=2, chaos=chaos, max_retries=3,
                            backoff_base_s=0.01, speculative=False)
    c._serverless_ex = ex
    for k in range(POLLS):
        res = ex.run(c.scheduler.poll(NOW + k * HOUR))
        assert res and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
    return c, ex


def _baseline(kind):
    if kind not in _BASELINES:
        c, _ = _run_polls(kind, None)
        _BASELINES[kind] = snapshot_stores(c)
    return _BASELINES[kind]


@pytest.mark.parametrize("fault", list(CHAOS))
@pytest.mark.parametrize("kind", list(CHAOS_MODELS))
def test_chaos_run_bitwise_equals_fault_free(kind, fault):
    chaos = ChaosPolicy(**CHAOS[fault])
    c, ex = _run_polls(kind, chaos)
    assert chaos.summary().get(fault, 0) >= 1, chaos.summary()
    s = ex.stats()
    if fault in ("kill", "drop"):
        assert s["retries"] >= 1 and s["failed_invocations"] >= 1
    assert s["chaos"][fault] >= 1
    assert_stores_bitwise_equal(_baseline(kind), c,
                                context=f"{kind}/{fault}")


def test_chaos_draws_are_deterministic():
    def draws(seed):
        pol = ChaosPolicy(seed=seed, kill_mid_action=0.2, drop_result=0.2,
                          duplicate=0.2, delay=0.2, delay_s=0.0)
        out = []
        for i in range(40):
            p = InvocationPayload(invocation_id=f"inv-{i:06d}", jobs=())
            out.append((pol.kill_point(p), pol.should_drop(p),
                        pol.should_duplicate(p),
                        pol.maybe_delay(p) > 0.0))
        return out
    a, b = draws(5), draws(5)
    assert a == b
    assert a != draws(6)
    assert any(x != (None, False, False, False) for x in a)
    assert any(x == (None, False, False, False) for x in a)


def test_chaos_respects_max_attempt():
    pol = ChaosPolicy(seed=0, kill_mid_action=1.0, drop_result=1.0,
                      max_attempt=1)
    first = InvocationPayload(invocation_id="inv-1", jobs=(), attempt=1)
    retry = InvocationPayload(invocation_id="inv-1", jobs=(), attempt=2)
    assert pol.kill_point(first) is not None and pol.should_drop(first)
    assert pol.kill_point(retry) is None and not pol.should_drop(retry)


class _KillSecondBin(ChaosPolicy):
    """Kill every multi-bin action's first delivery after EXACTLY one
    completed bin."""

    def kill_point(self, payload):
        if payload.attempt > self.max_attempt or payload.n_bins < 2:
            return None
        with self._lock:
            self.injected["kill"] = self.injected.get("kill", 0) + 1
        return 1


def test_kill_mid_multibin_action_retries_partial_effects():
    def run(chaos):
        c = _lr(4)
        ex = ServerlessExecutor(c, n_workers=2, chaos=chaos, max_retries=3,
                                backoff_base_s=0.01, speculative=False)
        c._serverless_ex = ex
        assert all(r.ok for r in ex.run(c.scheduler.poll(NOW)))
        res = ex.run(c.scheduler.poll(NOW + 3 * HOUR))
        assert len(res) == 12 and all(r.ok for r in res), \
            [r.error for r in res if not r.ok]
        return c, ex
    ref, _ = run(None)
    chaos = _KillSecondBin()
    got, ex = run(chaos)
    assert chaos.summary()["kill"] >= 1
    assert ex.stats()["retries"] >= 1
    assert_stores_bitwise_equal(ref, got, context="multibin-kill")


# ------------------------------------------------- storage properties
_DTYPES = ("float32", "float64", "int32", "int64")


def _roundtrip_payload(storage, vals, dtype_i, attempt):
    arr = np.asarray(vals, dtype=_DTYPES[dtype_i])
    job = JobRef(f"d{dtype_i}", "lr", "1.0", "score", NOW + attempt,
                 "ENERGY_LOAD", "E0", f"pk{dtype_i}")
    vr = VersionRef("d0", 1 + attempt, NOW - HOUR,
                    model_object={"params": {"w": torch.from_numpy(arr)},
                                  "nested": [arr[:1], {"b": arr * 2}],
                                  "scale": 2.5})
    p = InvocationPayload(invocation_id=f"inv-{dtype_i}-{attempt}",
                          jobs=(job,), versions=(vr,),
                          created_at=1.5, attempt=attempt)
    q = get_payload(storage, put_payload(storage, p))
    assert q.invocation_id == p.invocation_id and q.attempt == p.attempt
    assert q.jobs == p.jobs
    mo = q.versions[0].model_object
    for got, ref in ((mo["params"]["w"], arr),
                     (mo["nested"][0], arr[:1]),
                     (mo["nested"][1]["b"], arr * 2)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
    assert mo["scale"] == 2.5

    res = InvocationResult(
        invocation_id=p.invocation_id, worker_id="w0", cold_start=False,
        started_at=2.0, finished_at=3.0,
        outcomes=(JobOutcome(ref=job, ok=True, duration_s=0.1),),
        forecasts=(ForecastBlob(
            deployment_name=job.deployment_name, signal=job.signal,
            entity=job.entity, created_at=job.scheduled_at,
            times=np.asarray(vals, dtype="float64"),
            values=arr.astype("float64") * 0.5, model_version=1),))
    r = get_result(storage, put_result(storage, res, p.attempt))
    assert r.outcomes == res.outcomes
    fb, fb0 = r.forecasts[0], res.forecasts[0]
    assert fb.times.tobytes() == fb0.times.tobytes()
    assert fb.values.tobytes() == fb0.values.tobytes()


@settings(max_examples=20, **UNTIMED)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6),
                min_size=0, max_size=32),
       st.integers(min_value=0, max_value=3),
       st.integers(min_value=1, max_value=4))
def test_storage_roundtrip_inmemory_bitwise(vals, dtype_i, attempt):
    _roundtrip_payload(InMemoryStorage(), vals, dtype_i, attempt)


@settings(max_examples=10, **UNTIMED)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6),
                min_size=0, max_size=32),
       st.integers(min_value=0, max_value=3),
       st.integers(min_value=1, max_value=4))
def test_storage_roundtrip_filesystem_bitwise(vals, dtype_i, attempt):
    with tempfile.TemporaryDirectory() as root:
        _roundtrip_payload(FilesystemStorage(root), vals, dtype_i, attempt)


def test_storage_semantics():
    for storage in (InMemoryStorage(), FilesystemStorage()):
        storage.put("jobs/a/1.json", b"one")
        storage.put("jobs/a/2.json", b"two")
        storage.put("results/a/1.json", b"three")
        assert storage.get("jobs/a/2.json") == b"two"
        assert storage.list("jobs/") == ["jobs/a/1.json", "jobs/a/2.json"]
        assert storage.list() == ["jobs/a/1.json", "jobs/a/2.json",
                                  "results/a/1.json"]
        storage.put("jobs/a/2.json", b"TWO")
        assert storage.get("jobs/a/2.json") == b"TWO"
        assert storage.delete("jobs/a/2.json")
        assert not storage.delete("jobs/a/2.json")
        with pytest.raises(StorageKeyError):
            storage.get("jobs/a/2.json")
        for bad in ("", "../escape", "a/../b", "a b", "jobs/é"):
            with pytest.raises(ValueError):
                storage.put(bad, b"x")
        st_ = storage.stats()
        assert st_["objects"] == 2 and st_["puts"] == 4
        storage.clear()
        assert storage.list() == []
        storage.close()


def test_filesystem_storage_owned_root_removed_on_close():
    storage = FilesystemStorage()
    root = storage.root
    storage.put("jobs/x.json", b"x")
    assert os.path.isdir(root)
    storage.close()
    assert not os.path.exists(root)
    with tempfile.TemporaryDirectory() as shared:
        FilesystemStorage(shared).close()
        assert os.path.isdir(shared)


def test_inline_backend_storage_mediated_bitwise():
    storage = InMemoryStorage()
    ref, _ = _run_polls("lr", None)
    c = _lr(N)
    ex = ServerlessExecutor(c, n_workers=2, storage=storage,
                            speculative=False)
    c._serverless_ex = ex
    for k in range(POLLS):
        res = ex.run(c.scheduler.poll(NOW + k * HOUR))
        assert res and all(r.ok for r in res)
    assert_stores_bitwise_equal(ref, c, context="storage-mediated")
    st_ = ex.stats()["storage"]
    assert st_["puts"] >= 2 * st_["gets"] / 2 >= 2
    assert st_["bytes_in"] > 0 and st_["bytes_out"] > 0
    assert storage.list("jobs/") and storage.list("results/")
    assert payload_key("inv-000001", 1) in storage.list("jobs/")


# ------------------------------------------------- futures / wait
def _complete_later(fut, delay, value):
    def run():
        time.sleep(delay)
        fut._set_result(value)
    threading.Thread(target=run, daemon=True).start()


def test_wait_any_returns_in_completion_order():
    fs = [ResponseFuture(f"inv-{i}") for i in range(3)]
    _complete_later(fs[0], 0.30, "slow")
    _complete_later(fs[1], 0.02, "fast")
    _complete_later(fs[2], 0.15, "mid")
    done, pending = wait(fs, return_when=ANY_COMPLETED, timeout=5.0)
    assert [f.invocation_id for f in done] == ["inv-1"]
    assert len(pending) == 2
    done, pending = wait(fs, timeout=5.0)
    assert not pending
    assert [f.invocation_id for f in done] == ["inv-1", "inv-2", "inv-0"]
    assert [f.result() for f in done] == ["fast", "mid", "slow"]


def test_wait_always_never_blocks():
    fs = [ResponseFuture("a"), ResponseFuture("b")]
    fs[0]._set_result(1)
    t0 = time.perf_counter()
    done, pending = wait(fs, return_when=ALWAYS)
    assert time.perf_counter() - t0 < 0.05
    assert [f.invocation_id for f in done] == ["a"]
    assert [f.invocation_id for f in pending] == ["b"]


def test_wait_timeout_cancels_pending_and_raises():
    fs = [ResponseFuture(f"inv-{i}") for i in range(2)]
    _complete_later(fs[0], 0.02, "ok")
    with pytest.raises(FuturesTimeoutError) as ei:
        wait(fs, timeout=0.2)
    assert [f.invocation_id for f in ei.value.pending] == ["inv-1"]
    assert fs[1].cancelled and fs[1].done
    assert fs[1].result(throw_except=False) is None
    assert fs[0].success and fs[0].result() == "ok"
    assert not fs[1]._set_result("late")
    assert fs[1].cancelled


class _DelayNth(InlineBackend):
    """Delays the Nth (1-based) invoke call."""

    def __init__(self, system, *, n_workers=2, nth=2, delay_s=0.6):
        super().__init__(system, n_workers=n_workers)
        self.nth, self.delay_s = nth, delay_s
        self._calls = 0
        self._calls_lock = threading.Lock()

    def invoke(self, payload, worker_id):
        with self._calls_lock:
            self._calls += 1
            me = self._calls
        if me == self.nth:
            time.sleep(self.delay_s)
        return super().invoke(payload, worker_id)


def test_run_async_streams_results_before_slowest_completes():
    c = _lr(2)
    ex = ServerlessExecutor(c, backend=_DelayNth(c, nth=2, delay_s=0.8),
                            aggregation=2, speculative=False)
    c._serverless_ex = ex
    assert all(r.ok for r in ex.run(c.scheduler.poll(NOW)))
    jobs = c.scheduler.poll(NOW + 2 * HOUR)
    assert len(jobs) == 4
    ex.backend.nth = ex.backend._calls + 2
    fs = ex.run_async(jobs)
    assert len(fs) == 2
    done, pending = wait(fs, return_when=ANY_COMPLETED, timeout=30.0)
    assert len(done) == 1 and len(pending) == 1
    assert not pending[0].done
    done_stamps = {r.scheduled_at for r in done[0].payload.jobs}
    hist = {f.created_at for f in c.predictions.history("s-Z_PRO_0_0")}
    assert done_stamps <= hist
    pending_stamps = {r.scheduled_at for r in pending[0].payload.jobs}
    assert not (pending_stamps & hist)
    done, pending = wait(fs, timeout=30.0)
    assert not pending and all(f.success for f in done)
    assert len(c.predictions.history("s-Z_PRO_0_0")) == 3


def test_run_async_rejects_mixed_phases():
    c = _lr(2)
    ex = ServerlessExecutor(c, n_workers=1, speculative=False)
    c._serverless_ex = ex
    jobs = c.scheduler.poll(NOW)
    with pytest.raises(ValueError, match="single-phase"):
        ex.run_async(jobs)
    assert all(r.ok for r in ex.run(jobs))


def test_wait_timeout_cancellation_stops_retries_and_requeues():
    c = _lr(2)
    ex = ServerlessExecutor(c, backend=_DelayNth(c, nth=1, delay_s=0.8),
                            speculative=False, max_retries=5)
    c._serverless_ex = ex
    assert all(r.ok for r in ex.run(c.scheduler.poll(NOW)))
    jobs = c.scheduler.poll(NOW + HOUR)
    ex.backend.nth = ex.backend._calls + 1
    fs = ex.run_async(jobs)
    with pytest.raises(FuturesTimeoutError):
        wait(fs, timeout=0.1)
    assert all(f.cancelled for f in fs)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        refire = c.scheduler.poll(NOW + HOUR + 1.0)
        if refire:
            break
        time.sleep(0.05)
    assert sorted({j.scheduled_at for j in refire}) == [NOW + HOUR]
    assert ex.stats()["retries"] == 0
    assert all(r.ok for r in ex.run(refire))
    assert len(c.predictions.history("s-Z_PRO_0_0")) == 2


# ------------------------------------------------- autoscaler
def test_autoscaler_scales_out_and_reaps_deterministically():
    c = _lr(2)
    be = InlineBackend(c, n_workers=2)
    pol = AutoscalePolicy(min_workers=2, max_workers=4,
                          target_queue_p95_s=0.5, idle_ttl_s=10.0)
    a = Autoscaler(be, pol, InvocationMonitor())
    t = 100.0
    a.observe(backlog=3, busy={"w0": 1, "w1": 1}, now=t)
    assert be.worker_ids() == ["w0", "w1", "w2"]
    a.observe(backlog=3, busy={w: 1 for w in be.worker_ids()}, now=t + 1)
    assert be.worker_ids() == ["w0", "w1", "w2", "w3"]
    a.observe(backlog=9, busy={w: 1 for w in be.worker_ids()}, now=t + 2)
    assert len(be.worker_ids()) == 4
    a.observe(backlog=5, busy={"w0": 1}, now=t + 3)
    assert len(be.worker_ids()) == 4
    a.note_dispatch("w0", now=t + 3)
    reaped = a.reap_idle(busy={"w0": 1}, now=t + 50)
    assert len(be.worker_ids()) == pol.min_workers
    assert "w0" in be.worker_ids() and set(reaped) & {"w2", "w3"}
    s = a.summary()
    assert s["scale_outs"] == 2 and s["reaps"] == 2
    assert s["peak_workers"] == 4 and s["workers"] == 2
    assert [e["action"] for e in s["events"]] \
        == ["scale_out", "scale_out", "reap", "reap"]
    assert be.add_worker() == "w4"


def test_autoscaler_queue_p95_signal():
    c = _lr(2)
    be = InlineBackend(c, n_workers=1)
    mon = InvocationMonitor()
    for i in range(10):
        p = InvocationPayload(invocation_id=f"inv-{i}", jobs=(),
                              created_at=0.0)
        r = InvocationResult(invocation_id=p.invocation_id, worker_id="w0",
                             cold_start=False, started_at=2.0,
                             finished_at=2.1, outcomes=())
        mon.record(payload=p, result=r, worker_id="w0")
    assert mon.recent_queue_p95() == pytest.approx(2.0)
    a = Autoscaler(be, AutoscalePolicy(min_workers=1, max_workers=2,
                                       target_queue_p95_s=0.5), mon)
    a.observe(backlog=1, busy={}, now=50.0)
    assert len(be.worker_ids()) == 2
    assert a.summary()["events"][0]["reason"] == "queue_p95"


class _SlowBackend(InlineBackend):
    def invoke(self, payload, worker_id):
        time.sleep(0.05)
        return super().invoke(payload, worker_id)


def test_elastic_executor_scales_under_load_and_reaps_idle():
    c = _lr(4)
    cref = _lr(4)
    exref = ServerlessExecutor(cref, n_workers=1, speculative=False)
    cref._serverless_ex = exref
    be = _SlowBackend(c, n_workers=1)
    ex = ServerlessExecutor(
        c, backend=be, aggregation=4, speculative=False,
        autoscale=AutoscalePolicy(min_workers=1, max_workers=3,
                                  target_queue_p95_s=0.01, idle_ttl_s=0.0))
    c._serverless_ex = ex
    assert all(r.ok for r in ex.run(c.scheduler.poll(NOW)))
    assert all(r.ok for r in exref.run(cref.scheduler.poll(NOW)))
    res = ex.run(c.scheduler.poll(NOW + 6 * HOUR))
    assert len(res) == 24 and all(r.ok for r in res), \
        [r.error for r in res if not r.ok]
    assert all(r.ok for r in exref.run(cref.scheduler.poll(NOW + 6 * HOUR)))
    s = ex.stats()
    assert s["autoscale"]["scale_outs"] >= 1
    assert s["autoscale"]["peak_workers"] >= 2
    assert s["autoscale"]["reaps"] >= 1 and s["workers"] == 1
    assert_stores_bitwise_equal(cref, c, context="elastic")


# ------------------------------------------------------------ process


def _mini_castor():
    """Cheapest picklable system factory: the spawn-handshake tests only
    need the worker process to come up."""
    from repro_torch.core import Castor
    return Castor(device="cpu")


def _process_backend(factory, **kw):
    return ProcessBackend(factory, n_workers=1,
                          spawn_timeout_s=SPAWN_TIMEOUT_S,
                          invoke_timeout_s=INVOKE_TIMEOUT_S, **kw)


def test_process_backend_workers_reaped_on_gc():
    import gc
    be = _process_backend(_mini_castor)
    (proc, _tq, _rq), _lock = be._worker("p0")
    assert proc.is_alive()
    del be
    gc.collect()
    proc.join(timeout=10.0)
    assert not proc.is_alive(), "orphaned worker survived backend GC"


def test_process_backend_context_manager_reaps_and_cleans_storage():
    with _process_backend(_mini_castor) as be:
        (proc, _tq, _rq), _lock = be._worker("p0")
        root = be.storage.root
        assert proc.is_alive() and os.path.isdir(root)
    proc.join(timeout=10.0)
    assert not proc.is_alive()
    assert not os.path.exists(root)
    be.close()


def test_process_backend_smoke_matches_fleet():
    """A spawned worker (storage-mediated wire, artifact ship-back): the
    forecasts equal the fleet executor's at rtol 1e-6 / atol 1e-8, the
    versions shipped back hold tensors on the invoker's device with its
    lineage numbering, and the worker's spans name the device it ran on."""
    factory = functools.partial(build_steady_castor, "lr",
                                LinearForecaster, {}, n=2, device="cpu")
    c = factory()
    cf = factory()
    ex = ServerlessExecutor(c, backend=_process_backend(factory),
                            speculative=False)
    mark = c.tracer.mark()
    try:
        for k in range(2):
            rb = ex.run(c.scheduler.poll(NOW + k * HOUR))
            assert rb and all(r.ok for r in rb), \
                [r.error for r in rb if not r.ok]
            ra = cf.tick(NOW + k * HOUR, executor="fleet")
            assert all(r.ok for r in ra)
        for i in range(2):
            fa = cf.predictions.history(f"s-Z_PRO_0_{i}")
            fb = c.predictions.history(f"s-Z_PRO_0_{i}")
            assert len(fa) == len(fb) == 2
            for x, y in zip(fa, fb):
                np.testing.assert_allclose(y.values, x.values,
                                           rtol=1e-6, atol=1e-8)
                assert y.model_version == x.model_version
            (mv,) = c.versions.history(f"s-Z_PRO_0_{i}")
            theta = mv.params["params"]["theta"]
            assert torch.is_tensor(theta) and theta.device == c.device
            assert torch.equal(theta, cf.versions.get(
                f"s-Z_PRO_0_{i}").params["params"]["theta"])
        s = ex.stats()
        assert s["cold_starts"] == 1 and s["warm_starts"] >= 1
        assert s["queue_s_p95"] >= 0.0
        spans = [sp for sp in c.tracer.export_since(mark)
                 if sp["name"] == "worker.execute"]
        assert len(spans) == s["invocations"]
        assert {sp["args"]["device"] for sp in spans} == {"cpu"}
        assert all(sp["args"]["fleet_mlp_launches"] == 0 for sp in spans)
    finally:
        ex.close()


def test_tracer_mark_after_clear_exports_only_later_spans():
    """``export_since(mark())`` after a ``clear()`` ships only the spans
    finished after the mark (the sequence restarts with the count)."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer()
    for name in ("a", "b"):
        with tr.span(name):
            pass
    tr.clear()
    with tr.span("c"):
        pass
    mark = tr.mark()
    with tr.span("d"):
        pass
    assert [sp["name"] for sp in tr.export_since(mark)] == ["d"]


def test_inline_worker_span_counts_this_process_fleet_mlp_launches():
    """An inline worker's span names the system's device and this
    process's fleet_mlp launches, which an ANN score bin raises by one
    per horizon step."""
    c = _steady("ann", ANNForecaster, {"hidden": 8, "epochs": 5}, n=2)
    mark = c.tracer.mark()
    fleet_mlp_ops.reset_invocation_count()
    assert all(r.ok for r in c.tick(NOW, executor="serverless"))
    spans = [sp for sp in c.tracer.export_since(mark)
             if sp["name"] == "worker.execute"]
    assert [sp["args"]["device"] for sp in spans] == ["cpu", "cpu"]
    assert spans[-1]["args"]["fleet_mlp_launches"] == 24


# ------------------------------------------------ chip_smoke rehearsal


def test_chip_smoke_durable_serverless_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's durable serverless phase at a tiny size on the CPU
    (the plain versions): the durable inline flow against the fleet
    executor's, the torn-log recovery bitwise, and two spawned workers
    (they import chip_smoke by name for their factory) against an inline
    run — the same checks the card run makes."""
    import importlib
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.delitem(sys.modules, "chip_smoke", raising=False)
    smoke = importlib.import_module("chip_smoke")
    size = dict(n_prosumers=4, hidden=16, sub_width=8, epochs=40)
    ref = smoke.forecast_flow("cpu", **size)
    out = smoke.durable_serverless_flow("cpu", ref, process_prosumers=4,
                                        **size)
    assert out["durable"]["launches"] == 24 * 2 * 3
    assert out["recovery"]["bytes"] > 0
    assert out["process"]["child_launches"] == 24 * 2 * 2
