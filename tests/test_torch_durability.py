"""The port's durability subsystem (``repro_torch.durability``) against the
JAX package's, on the CPU.

* The WAL codec writes the same bytes: ``encode_record``/``frame_records``
  frames are byte-identical to ``repro.durability.wal``'s for the same
  numpy records, and a port model object (tensors) encodes exactly as the
  JAX package encodes its numpy image (``version_to_numpy``).
* A WAL written by the JAX package's ``Castor.open`` recovers into the
  port's ``Castor.open(device="cpu")``: stores bitwise-equal, versions
  bitwise-equal in the port's dtypes, and the next score poll equal to the
  JAX package's at FLEET_RTOL/ATOL.
* Twins of ``tests/test_durability.py``: codec properties, group commit,
  auto-flush, the pipelined barrier, snapshot compaction and its corrupt
  fallback, close and the context manager, the filesystem path, the
  weather seed, crash-restart bitwise for LR/GAM/ANN/LSTM, the detection
  flow and the serverless executor, the live torn write, a crash-state
  sweep and the scheduler's retry stamps.
"""
import os

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _property_settings import UNTIMED
from repro.core.castor import Castor as JaxCastor
from repro.core.deployment import deployment_record as jax_deployment_record
from repro.durability import wal as jax_wal
from repro.forecast import ANNForecaster as JaxANN
from repro.forecast import LinearForecaster as JaxLR
from repro.serverless.payload import _enc as jax_enc
from repro.serverless.storage import InMemoryStorage as JaxMemory
from repro.testing import drive_plan as jax_drive_plan
from repro.testing import snapshot_stores as jax_snapshot_stores
from repro.testing import steady_plan as jax_steady_plan
from repro_torch.core.castor import Castor, MINUTE
from repro_torch.core.deployment import deployment_record
from repro_torch.durability.chaos import (CrashingStorage, ProcessCrash,
                                          clone_to_memory, crash_states)
from repro_torch.durability.journal import (Journal, load_records,
                                            replay_records, snapshot_records)
from repro_torch.durability.wal import (HEADER_SIZE, decode_records,
                                        encode_record, frame_records,
                                        split_frames)
from repro_torch.forecast import (ANNForecaster, GAMForecaster,
                                  LSTMForecaster, LinearForecaster,
                                  version_from_numpy, version_to_numpy)
from repro_torch.serverless.payload import _enc
from repro_torch.serverless.storage import FilesystemStorage, InMemoryStorage
from repro_torch.testing import (FLEET_ATOL, FLEET_NOW, FLEET_RTOL,
                                 assert_stores_bitwise_equal,
                                 build_steady_castor, detection_plan,
                                 drive_plan, snapshot_stores, steady_plan)

torch.set_num_threads(1)

MODELS = {
    "lr": (LinearForecaster, {}),
    "gam": (GAMForecaster, {}),
    "ann": (ANNForecaster, {"hidden": 8, "epochs": 20}),
    "lstm": (LSTMForecaster, {"hidden": 8, "epochs": 20}),
}
CPU = {"device": "cpu"}


def _open(**kw):
    return Castor.open(device="cpu", **kw)


# ------------------------------------------------- codec, both packages


def _mk_records(chunks):
    """Turn a list of float-lists into framed ("ts", ...) records."""
    return [("ts", {"id": f"s{i}", "t": np.asarray(c, np.float64),
                    "v": np.asarray(c, np.float64) * 2.0})
            for i, c in enumerate(chunks)]


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for (op_g, d_g), (op_w, d_w) in zip(got, want):
        assert op_g == op_w
        assert d_g["id"] == d_w["id"]
        assert d_g["t"].dtype == d_w["t"].dtype
        assert d_g["t"].tobytes() == d_w["t"].tobytes()
        assert d_g["v"].tobytes() == d_w["v"].tobytes()


@settings(max_examples=25, **UNTIMED)
@given(st.lists(st.lists(st.floats(min_value=-1e12, max_value=1e12),
                         min_size=0, max_size=7),
                min_size=0, max_size=6))
def test_frames_byte_identical_to_jax_package(chunks):
    """The same numpy records frame to the same bytes in both packages,
    and each package decodes the other's segment."""
    recs = _mk_records(chunks)
    mine = [encode_record(op, obj) for op, obj in recs]
    theirs = [jax_wal.encode_record(op, obj) for op, obj in recs]
    assert mine == theirs
    blob = frame_records(mine)
    assert blob == jax_wal.frame_records(theirs)
    for decode in (decode_records, jax_wal.decode_records):
        got, valid, clean = decode(blob)
        assert clean and valid == len(blob)
        _assert_records_equal(got, recs)
    assert len(split_frames(blob)) == len(recs)


@settings(max_examples=25, **UNTIMED)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6),
                min_size=1, max_size=9),
       st.integers(min_value=0, max_value=10**9))
def test_codec_truncation_yields_longest_valid_prefix(chunk, cut_seed):
    recs = _mk_records([chunk, chunk[::-1], chunk])
    frames = [encode_record(op, obj) for op, obj in recs]
    blob = b"".join(frames)
    cut = cut_seed % len(blob)          # every byte offset reachable
    got, valid, clean = decode_records(blob[:cut])
    want_n, pos = 0, 0
    for f in frames:
        if pos + len(f) <= cut:
            want_n += 1
            pos += len(f)
    assert len(got) == want_n
    assert valid == pos
    assert clean == (cut == pos)
    _assert_records_equal(got, recs[:want_n])


def test_codec_every_truncation_never_raises():
    recs = _mk_records([[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]])
    blob = b"".join(encode_record(op, obj) for op, obj in recs)
    for cut in range(len(blob) + 1):
        got, valid, _clean = decode_records(blob[:cut])
        assert valid <= cut
        _assert_records_equal(got, recs[:len(got)])


@settings(max_examples=25, **UNTIMED)
@given(st.integers(min_value=0, max_value=10**9),
       st.integers(min_value=1, max_value=255))
def test_codec_single_byte_corruption_detected(pos_seed, xor):
    recs = _mk_records([[1.0, 2.0, 3.0], [4.0], [5.0, 6.0]])
    frames = [encode_record(op, obj) for op, obj in recs]
    blob = bytearray(b"".join(frames))
    tail_start = len(blob) - len(frames[-1])
    pos = tail_start + pos_seed % len(frames[-1])
    blob[pos] ^= xor
    got, valid, clean = decode_records(bytes(blob))
    assert not clean
    assert len(got) == len(recs) - 1
    assert valid == tail_start
    _assert_records_equal(got, recs[:-1])


def test_codec_corrupt_mid_frame_drops_suffix():
    recs = _mk_records([[1.0], [2.0], [3.0]])
    frames = [encode_record(op, obj) for op, obj in recs]
    blob = bytearray(b"".join(frames))
    blob[len(frames[0]) + HEADER_SIZE + 2] ^= 0x40
    got, _valid, clean = decode_records(bytes(blob))
    assert not clean and len(got) == 1
    _assert_records_equal(got, recs[:1])


@pytest.fixture(scope="module")
def trained():
    """One small trained version per kind, as the port holds it."""
    out = {}
    for kind, (cls, hp) in MODELS.items():
        c = build_steady_castor(kind, cls, hp, n=2, **CPU)
        assert all(r.ok for r in c.tick(FLEET_NOW))
        out[kind] = c.versions.get("s-Z_PRO_0_0").params
    return out


@pytest.mark.parametrize("kind", list(MODELS))
def test_model_object_encodes_as_its_numpy_image(trained, kind):
    """A port model object (tensors) encodes, through the port's ``_enc``,
    to exactly the JAX package's encoding of its ``version_to_numpy``
    image — so its journal record is byte-identical too — and decodes back
    through ``version_from_numpy`` to the same tensors."""
    mo = trained[kind]
    image = version_to_numpy(mo)
    assert _enc(mo) == jax_enc(image)
    rec = {"model_id": "m", "trained_at": 1.0, "params": mo, "metadata": {}}
    frame = encode_record("mv", rec)
    assert frame == jax_wal.encode_record("mv", {**rec, "params": image})
    [(op, back)], _, clean = decode_records(frame)
    assert op == "mv" and clean
    got = version_from_numpy(back["params"], "cpu")
    for k, t in mo["params"].items():
        assert got["params"][k].dtype == t.dtype
        assert torch.equal(got["params"][k], t)
    for k in ("mu", "sd"):
        assert torch.equal(got[k], mo[k])
    assert got["y_scale"] == mo["y_scale"]
    assert got["resid_q"].tobytes() == mo["resid_q"].tobytes()


def test_codec_refuses_a_dtype_numpy_cannot_hold():
    with pytest.raises(TypeError, match="bfloat16"):
        encode_record("x", {"w": torch.zeros(3, dtype=torch.bfloat16)})


def test_version_from_numpy_passes_through_objects_without_tensors():
    for mo in ({"kind": "ANOM"}, {"kind": "XFORM", "config": {"a": 1}},
               {"w": np.arange(3.0)}):
        assert version_from_numpy(mo, "cpu") is mo


# ------------------------------------------- recovery across packages


def _jax_wal(kind, jcls, hp, polls):
    plan = jax_steady_plan(kind, jcls, hp, n=3, polls=polls + 1)
    storage = JaxMemory()
    jc = JaxCastor.open(storage=storage)
    jax_drive_plan(jc, plan, boundaries=plan["boundaries"][:polls])
    jc.journal.barrier()
    return jc, storage, plan


def _series(c):
    return {i: tuple(np.asarray(a).tobytes() for a in c.store.read(i))
            for i in c.store.ids()}


CROSS = {"lr": (JaxLR, LinearForecaster, {}),
         "ann": (JaxANN, ANNForecaster, {"hidden": 8, "epochs": 20})}


@pytest.mark.parametrize("kind", list(CROSS))
def test_jax_wal_recovers_into_the_port(kind):
    """The JAX package journals a train tick and two score polls; the port
    recovers that log. Series, deployments, forecasts, detections and the
    scheduler's state are bitwise-equal; every version, through
    ``version_to_numpy``, holds exactly the JAX version's values in the
    port's dtypes (f32 tensors; the JAX package keeps mu/sd in f64); the
    next score poll matches the JAX package's at FLEET_RTOL/ATOL."""
    jcls, cls, hp = CROSS[kind]
    jc, jstorage, plan = _jax_wal(kind, jcls, hp, polls=3)
    storage = InMemoryStorage()
    for key in jstorage.list():
        storage.put(key, jstorage.get(key))
    tc = _open(storage=storage)
    want, got = jax_snapshot_stores(jc), snapshot_stores(tc)
    for part in ("forecasts", "detections", "derived"):
        assert got[part] == want[part], part
    assert _series(tc) == _series(jc)
    assert [deployment_record(d) for d in tc.deployments.all()] == \
        [jax_deployment_record(d) for d in jc.deployments.all()]
    assert tc.scheduler.dump_state() == jc.scheduler.dump_state()
    n = 0
    for name in jc.versions.model_ids():
        for jm, tm in zip(jc.versions.history(name),
                          tc.versions.history(name), strict=True):
            assert (tm.version, tm.trained_at) == (jm.version, jm.trained_at)
            assert tm.params["params"]["w0" if kind == "ann" else
                                       "theta"].device.type == "cpu"
            g, w = version_to_numpy(tm.params), jm.params
            for k, v in w["params"].items():
                assert g["params"][k].tobytes() == \
                    np.asarray(v, g["params"][k].dtype).tobytes(), k
            for k in ("mu", "sd"):
                assert g[k].tobytes() == \
                    np.asarray(w[k], np.float32).tobytes(), k
            assert g["y_scale"] == w["y_scale"]
            assert g["resid_q"].tobytes() == w["resid_q"].tobytes()
            n += 1
    assert n == 3
    t = plan["boundaries"][3]
    tc.publish(kind, "1.0", cls)
    jres, tres = jc.tick(t), tc.tick(t)
    assert jres and all(r.ok for r in jres + tres)
    for name in jc.versions.model_ids():
        fj = jc.predictions.history(name)[-1]
        ft = tc.predictions.history(name)[-1]
        assert ft.created_at == fj.created_at == t
        for a, b in ((ft.values, fj.values), (ft.lower, fj.lower),
                     (ft.upper, fj.upper)):
            np.testing.assert_allclose(a, b, rtol=FLEET_RTOL,
                                       atol=FLEET_ATOL)
    tc.close()
    jc.close()


def test_port_wal_recovers_on_another_device_object():
    """The device is not journaled: a log recovers onto whatever device
    ``open`` is given (here a CPU log onto ``torch.device("cpu")``), and
    ``meta`` keeps only the format and the weather seed."""
    storage = InMemoryStorage()
    c = _open(storage=storage)
    c.journal.commit()
    c.close()
    recs, _ = load_records(storage)
    assert recs == [("meta", {"format": 1, "weather_seed": 7})]
    c2 = Castor.open(storage=storage, device=torch.device("cpu"))
    assert c2.device == torch.device("cpu")
    c2.close()


# -------------------------------------------------------------- journal


def test_journal_group_commit_one_segment_per_commit():
    storage = InMemoryStorage()
    j = Journal(storage)
    for i in range(10):
        j.append("ts", {"id": "a", "t": np.arange(3.0), "v": np.arange(3.0)})
    assert storage.list() == []
    assert j.commit()
    assert len(storage.list("wal/")) == 1
    assert not j.commit()
    j.append("meta", {"x": 1})
    j.commit()
    segs = storage.list("wal/")
    assert len(segs) == 2 and segs == sorted(segs)
    recs, stats = load_records(storage)
    assert len(recs) == 11 and stats["next_seq"] == 2


def test_journal_auto_flush_bounds_buffer():
    storage = InMemoryStorage()
    j = Journal(storage, max_buffer_bytes=1024)
    for i in range(50):
        j.append("ts", {"id": "a", "t": np.arange(16.0),
                        "v": np.arange(16.0)})
    assert j.auto_flushes > 0 and len(storage.list("wal/")) > 0
    j.commit()
    recs, _ = load_records(storage)
    assert len(recs) == 50


def test_journal_record_over_the_buffer_flushes_alone():
    """A record larger than ``max_buffer_bytes`` (a full-width ANN version
    is) flushes as its own segment at append time."""
    storage = InMemoryStorage()
    j = Journal(storage, max_buffer_bytes=1024)
    big = {"w": torch.zeros(1024)}
    for _ in range(3):
        j.append("mv", big)
    assert j.auto_flushes == 3 and len(storage.list("wal/")) == 3
    assert not j.commit()


def test_journal_close_idempotent_and_final():
    storage = InMemoryStorage()
    j = Journal(storage)
    j.append("meta", {"x": 1})
    j.close()
    assert len(storage.list("wal/")) == 1
    j.close()
    j.append("meta", {"x": 2})
    j.commit()
    recs, _ = load_records(storage)
    assert len(recs) == 1


def test_journal_pipelined_commit_barrier_and_order():
    storage = InMemoryStorage()
    j = Journal(storage, pipelined=True)
    for k in range(4):
        j.append("meta", {"k": k})
        j.commit()
    j.barrier()
    segs = storage.list("wal/")
    assert len(segs) == 4 and segs == sorted(segs)
    recs, _stats = load_records(storage)
    assert [d["k"] for _, d in recs] == [0, 1, 2, 3]
    j.close()
    crashing = CrashingStorage(InMemoryStorage(), puts_before_crash=0)
    j2 = Journal(crashing, pipelined=True)
    j2.append("meta", {"x": 1})
    j2.commit()
    j2.append("meta", {"x": 2})
    with pytest.raises(ProcessCrash):
        j2.commit()


def test_forecast_batch_record_roundtrip():
    from repro_torch.core.lineage import (Forecast, forecast_batch_record,
                                          forecasts_from_batch)
    rng = np.random.default_rng(5)

    def fc(i, h, banded=True):
        v = rng.normal(size=h)
        return Forecast(deployment_name=f"d{i}", signal="S", entity=f"e{i}",
                        created_at=float(i), times=np.arange(float(h)),
                        values=v, model_version=1,
                        lower=v - 1 if banded else None,
                        upper=v + 1 if banded else None)

    uniform = [fc(i, 7) for i in range(5)]
    d = forecast_batch_record(uniform)
    assert "meta" in d and d["times"].shape == (7,)
    mixed = [fc(0, 7), fc(1, 9), fc(2, 7, banded=False)]
    d2 = forecast_batch_record(mixed)
    assert "forecasts" in d2
    for batch, rec in ((uniform, d), (mixed, d2)):
        [(op, dec)] = decode_records(encode_record("fc", rec))[0]
        back = forecasts_from_batch(dec)
        assert len(back) == len(batch)
        for a, b in zip(batch, back):
            assert a.times.tobytes() == b.times.tobytes()
            assert a.values.tobytes() == b.values.tobytes()
            assert (a.lower is None) == (b.lower is None)


def test_snapshot_compacts_and_recovery_prefers_it():
    storage = InMemoryStorage()
    c = _open(storage=storage, snapshot_every=0)
    c.add_signal("S", "u")
    c.add_entity("E", "KIND")
    c.ingest("raw::E", np.arange(5.0), np.arange(5.0) * 2)
    c.link("raw::E", "S", "E")
    c.journal.commit()
    c.journal.snapshot()
    assert storage.list("wal/") == []
    snaps = storage.list("snap/")
    assert len(snaps) == 1
    c.ingest("raw::E", np.arange(5.0, 8.0), np.arange(5.0, 8.0) * 2)
    c.journal.commit()
    c.close()
    c2 = _open(storage=storage)
    t, v = c2.read("S", "E")
    np.testing.assert_array_equal(t, np.arange(8.0))
    np.testing.assert_array_equal(v, np.arange(8.0) * 2)
    assert c2._recovery_stats["snapshot"] == snaps[0]
    c2.close()


def test_snapshot_of_trained_versions_recovers_them_bitwise():
    """``snapshot_every`` compaction of a system holding trained versions
    (tensors): recovery from the snapshot alone is bitwise."""
    plan = steady_plan("ann", ANNForecaster, {"hidden": 8, "epochs": 10},
                       n=2, polls=2, **CPU)
    storage = InMemoryStorage()
    c = _open(storage=storage, snapshot_every=1)
    drive_plan(c, plan)
    c.journal.barrier()
    assert c.journal.snapshots >= 1
    c2 = _open(storage=clone_to_memory(storage))
    assert c2._recovery_stats["snapshot"] is not None
    assert_stores_bitwise_equal(c, c2, context="snapshot")
    c.close()
    c2.close()


def test_corrupt_snapshot_falls_back_without_data_loss():
    storage = InMemoryStorage()
    c = _open(storage=storage, snapshot_every=0, retain_segments=True)
    c.ingest("raw::x", np.arange(4.0), np.arange(4.0))
    c.journal.commit()
    c.journal.snapshot()
    c.close()
    key = storage.list("snap/")[0]
    blob = bytearray(storage.get(key))
    blob[len(blob) // 2] ^= 0xFF
    storage.put(key, bytes(blob))
    c2 = _open(storage=storage)
    assert c2._recovery_stats["corrupt_snapshots"] == 1
    assert c2._recovery_stats["snapshot"] is None
    t, _ = c2.store.read("raw::x")
    np.testing.assert_array_equal(t, np.arange(4.0))
    c2.close()


def test_snapshot_records_replay_into_equal_state():
    storage = InMemoryStorage()
    c = _open(storage=storage)
    c.add_signal("S")
    c.add_entity("P", "ROOT")
    c.add_entity("E", "KIND", parent="P")
    c.ingest("raw::E", np.arange(6.0), np.sin(np.arange(6.0)))
    c.link("raw::E", "S", "E")
    frames = b"".join(snapshot_records(c))
    recs, _valid, clean = decode_records(frames)
    assert clean
    c2 = Castor(**CPU)
    replay_records(c2, recs)
    assert c2.graph.parent("E").name == "P"
    np.testing.assert_array_equal(c2.store.read("raw::E")[0],
                                  c.store.read("raw::E")[0])
    c.close()


# ------------------------------------------------- Castor lifecycle


def test_castor_close_idempotent_and_context_manager():
    storage = InMemoryStorage()
    c = _open(storage=storage)
    c.ingest("raw::a", np.arange(3.0), np.arange(3.0))
    with c:
        c.close()
    c.close()
    recs, _ = load_records(storage)
    assert any(op == "ts" for op, _d in recs)
    p = Castor(**CPU)
    with p:
        p.close()
    p.close()


def test_castor_open_filesystem_path(tmp_path):
    root = str(tmp_path / "waldir")
    c = Castor.open(root, **CPU)
    c.add_signal("S")
    c.add_entity("E")
    c.ingest("raw::E", np.arange(4.0), np.arange(4.0) * 3)
    c.link("raw::E", "S", "E")
    c.close()
    c2 = Castor.open(root, **CPU)
    np.testing.assert_array_equal(c2.read("S", "E")[1], np.arange(4.0) * 3)
    c2.close()
    assert os.path.isdir(root)


def test_filesystem_storage_list_sorted_deterministic(tmp_path):
    fs = FilesystemStorage(root=str(tmp_path / "b"), fsync=True)
    keys = ["z/9.log", "a/10.log", "m.log", "a/2.log", "z/1.log", "b/x/y.log"]
    for k in keys:
        fs.put(k, b"x")
    assert fs.list() == sorted(keys)
    assert fs.list("a/") == ["a/10.log", "a/2.log"]
    assert fs.list() == fs.list()
    fs.close()


def test_weather_seed_survives_recovery():
    storage = InMemoryStorage()
    c = _open(storage=storage, weather_seed=99)
    c.journal.commit()
    c.close()
    c2 = _open(storage=storage, weather_seed=1)
    assert c2.weather_seed == 99
    c2.close()


def test_open_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Castor.open(storage=InMemoryStorage())


# ------------------------------------------- crash-restart end-to-end


def _run_durable(plan, storage, k=None, *, executor="fleet", **open_kw):
    c = _open(storage=storage, **open_kw)
    drive_plan(c, plan, executor=executor, boundaries=plan["boundaries"][:k])
    return c


def _crash_after(plan, k, *, executor="fleet"):
    """Run ``plan`` through boundary ``k`` on a durable system, then "kill
    -9" it: the returned storage is a byte copy of its log after the last
    commit landed."""
    storage = InMemoryStorage()
    mid = _run_durable(plan, storage, k=k, executor=executor)
    mid.journal.barrier()
    dead = clone_to_memory(storage)
    mid.close()
    return dead


@pytest.mark.parametrize("kind", list(MODELS))
def test_crash_restart_forecasters_bitwise(kind):
    cls, hp = MODELS[kind]
    plan = steady_plan(kind, cls, hp, n=2, polls=3, **CPU)
    ref = _run_durable(plan, InMemoryStorage())
    ref_snap = snapshot_stores(ref)
    ref.close()
    c = _open(storage=_crash_after(plan, 2))
    assert c.versions.count() > 0
    mv = c.versions.get("s-Z_PRO_0_0")
    assert all(torch.is_tensor(v) for v in mv.params["params"].values())
    drive_plan(c, plan)
    assert_stores_bitwise_equal(ref_snap, c, context=f"{kind} crash@2")
    c.close()


def test_crash_restart_detection_flow_bitwise():
    plan = detection_plan(n=2, minutes=8, **CPU)
    ref = _run_durable(plan, InMemoryStorage())
    ref_snap = snapshot_stores(ref)
    ref.close()
    c = _open(storage=_crash_after(plan, 5))
    assert c.detections.count() > 0
    drive_plan(c, plan)
    assert_stores_bitwise_equal(ref_snap, c, context="detection crash@5")
    c.close()


def test_crash_restart_serverless_executor_bitwise():
    plan = steady_plan("lr", LinearForecaster, {}, n=2, polls=2, **CPU)
    ref = _run_durable(plan, InMemoryStorage())
    ref_snap = snapshot_stores(ref)
    ref.close()
    c = _open(storage=_crash_after(plan, 1, executor="serverless"))
    drive_plan(c, plan, executor="serverless")
    assert_stores_bitwise_equal(ref_snap, c, context="serverless crash@1")
    assert c.stats()["serverless"]["invocations"] >= 1
    c.close()


def test_live_torn_write_crash_recovers():
    plan = steady_plan("lr", LinearForecaster, {}, n=2, polls=3, **CPU)
    ref = _run_durable(plan, InMemoryStorage())
    ref_snap = snapshot_stores(ref)
    ref.close()
    inner = InMemoryStorage()
    crashing = CrashingStorage(inner, puts_before_crash=2,
                               torn_fraction=0.5)
    with pytest.raises(ProcessCrash):
        _run_durable(plan, crashing).journal.barrier()
    assert crashing.crashed
    c = _open(storage=inner)
    assert c._recovery_stats["torn_segments"] == 1
    drive_plan(c, plan)
    assert_stores_bitwise_equal(ref_snap, c, context="live torn write")
    c.close()


def test_crash_state_sweep_smoke():
    plan = detection_plan(n=2, minutes=4, **CPU)
    storage = InMemoryStorage()
    ref = _run_durable(plan, storage, snapshot_every=3,
                       retain_segments=True)
    ref_snap = snapshot_stores(ref)
    ref.close()
    states = list(crash_states(storage, torn=True, stride=4))
    assert len(states) > 5
    for label, st_ in states:
        c = _open(storage=st_)
        drive_plan(c, plan)
        assert_stores_bitwise_equal(ref_snap, c, context=label)
        c.close()


def test_scheduler_retry_stamps_survive_restart():
    from repro_torch.core.scheduler import Job
    plan = steady_plan("lr", LinearForecaster, {}, n=2, polls=1, **CPU)
    storage = InMemoryStorage()
    c = _run_durable(plan, storage)
    name = c.deployments.all()[0].name
    job = Job(deployment_name=name, package="lr", version="1.0",
              task="train", scheduled_at=FLEET_NOW,
              signal="ENERGY_LOAD", entity=c.deployments.get(name).entity)
    c.scheduler.mark_failed(job)
    c._commit_tick()
    c.journal.barrier()
    dead = clone_to_memory(storage)
    c.close()
    c2 = _open(storage=dead)
    assert (name, "train") in c2.scheduler._failed
    for pkg, ver, cls in plan["publish"]:
        c2.publish(pkg, ver, cls)
    jobs = c2.tick(FLEET_NOW + MINUTE)
    stamps = [r.job.scheduled_at for r in jobs
              if r.job.deployment_name == name and r.job.task == "train"]
    assert stamps == [FLEET_NOW]
    assert all(r.ok for r in jobs)
    c2.close()


def test_tick_commits_on_an_empty_poll_and_mirrors_wal_gauges():
    """An empty poll still group-commits what was ingested before it, and
    ``snapshot()`` mirrors the journal into the ``wal.*`` gauges."""
    storage = InMemoryStorage()
    c = _open(storage=storage)
    c.ingest("raw::a", np.arange(3.0), np.arange(3.0))
    assert c.tick(0.0) == []
    c.journal.barrier()
    assert len(storage.list("wal/")) == 1
    snap = c.snapshot()
    assert snap["stats"]["durability"]["segments"] == 1
    assert snap["metrics"]["wal.segments"] == 1
    c.close()
