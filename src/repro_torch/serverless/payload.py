"""Stateless, serializable invocation payloads (paper §2 step 8; the
Lithops/IBM-Cloud-Functions invocation pipeline adapted to this repro).

A serverless action must be reconstructable by a worker that shares
NOTHING with the invoker but the stores: payloads therefore carry only
*references* — deployment names, resolved implementation versions, the
occurrence's ``scheduled_at`` stamp, bin keys — plus (for backends whose
workers do not share the invoker's memory) the model-version artifacts a
scoring action needs, encoded as plain arrays. Never live objects: no
model instances, no executors, no store handles.

Everything here round-trips through JSON (``to_json``/``from_json``), and
the process backend ships payloads/results as JSON strings over the wire,
which *proves* statelessness — an object that survives the JSON boundary
cannot be secretly sharing state with the invoker. Arrays are encoded as
(dtype, shape, base64-of-bytes) so the round-trip is bitwise. A tensor (the
port's model objects hold them, on the system's device) is encoded as its
numpy image under the same tag, so a record written here is byte for byte
the one written for the same values held as numpy arrays; it decodes as
numpy, and ``forecast.base.version_from_numpy`` puts a decoded model object
back on a system's device.
"""
from __future__ import annotations

import base64
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.interning import InternTable
from ..core.scheduler import Job

# ---------------------------------------------------------------- arrays


def _numpy_image(t: torch.Tensor) -> np.ndarray:
    """The bitwise host image of a tensor (a copy from the device when it
    lies on one). Raises ``TypeError`` on a dtype numpy cannot hold."""
    try:
        return t.detach().cpu().numpy()
    except TypeError:
        raise TypeError(f"cannot encode a {t.dtype} tensor: numpy has no "
                        f"such dtype") from None


def _enc(obj: Any) -> Any:
    """Recursively encode numpy arrays/scalars (and tensors, through their
    numpy image) into JSON-able structures."""
    if isinstance(obj, torch.Tensor):
        obj = _numpy_image(obj)
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__nd__": [str(a.dtype), list(a.shape),
                           base64.b64encode(a.tobytes()).decode("ascii")]}
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return {"__np__": [str(obj.dtype),
                           base64.b64encode(
                               np.asarray(obj).tobytes()).decode("ascii")]}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj:
            dtype, shape, b64 = obj["__nd__"]
            a = np.frombuffer(base64.b64decode(b64), dtype=np.dtype(dtype))
            return a.reshape([int(s) for s in shape]).copy()
        if "__np__" in obj:
            dtype, b64 = obj["__np__"]
            return np.frombuffer(base64.b64decode(b64),
                                 dtype=np.dtype(dtype))[0]
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


# ---------------------------------------------------------------- refs


@dataclass(frozen=True)
class JobRef:
    """A scheduled occurrence by reference — the serializable twin of
    ``core.scheduler.Job`` (which is already pure primitives)."""
    deployment_name: str
    package: str
    version: str
    task: str
    scheduled_at: float
    signal: str
    entity: str
    user_params_key: str = ""

    @classmethod
    def from_job(cls, job: Job) -> "JobRef":
        return cls(job.deployment_name, job.package, job.version, job.task,
                   job.scheduled_at, job.signal, job.entity,
                   job.user_params_key)

    def to_job(self) -> Job:
        return Job(deployment_name=self.deployment_name, package=self.package,
                   version=self.version, task=self.task,
                   scheduled_at=self.scheduled_at, signal=self.signal,
                   entity=self.entity, user_params_key=self.user_params_key)


@dataclass(frozen=True)
class VersionRef:
    """A model-version artifact: what a scoring worker 'downloads' from the
    artifact store. ``model_object`` is the persisted params pytree (data,
    not a live object: numpy once decoded, the system's tensors when built
    from its own store)."""
    deployment_name: str
    version: int                      # the INVOKER store's version number
    trained_at: float
    model_object: Any = None


@dataclass(frozen=True)
class ForecastBlob:
    """A worker-produced rolling-horizon forecast, shipped back for the
    invoker to persist (idempotent on (deployment, created_at))."""
    deployment_name: str
    signal: str
    entity: str
    created_at: float
    times: np.ndarray
    values: np.ndarray
    model_version: int
    rank: int = 0
    # q10/q90 prediction band (None for band-less models) — also what a
    # detection payload ships TO workers as the band to compare against
    lower: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None


@dataclass(frozen=True)
class DetectionBlob:
    """A worker-produced detection occurrence, shipped back for the
    invoker to persist (idempotent on (deployment, scheduled_at)) — the
    detection flow's twin of ``ForecastBlob``. Fields mirror
    ``flows.detection.DetectionRecord``; all primitives, so the JSON
    round-trip is trivially bitwise."""
    deployment_name: str
    signal: str
    entity: str
    scheduled_at: float
    score: float
    n_readings: int
    n_anomalies: int
    band_misses: int
    model_version: int
    derived_signal: str


# ---------------------------------------------------------------- payload


@dataclass(frozen=True)
class InvocationPayload:
    """One serverless action: an *aggregate* of whole job bins (the paper
    groups many modelling tasks into one invocation). Bins are never split
    across payloads — a fleet bin is one megabatched computation, and
    splitting it would change batch shapes and thus f32 numerics."""
    invocation_id: str
    jobs: Tuple[JobRef, ...]
    versions: Tuple[VersionRef, ...] = ()      # score-phase artifacts
    bands: Tuple[ForecastBlob, ...] = ()       # detect-phase artifacts
    created_at: float = 0.0                    # wall-clock enqueue time
    attempt: int = 1
    # trace context ({"trace_id", "parent_id"}) riding the payload so a
    # share-nothing worker's spans stitch under the invoker's trace —
    # the cross-process half of the observability plane (obs/trace.py)
    trace: Optional[Dict[str, int]] = None

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def n_bins(self) -> int:
        return len({r.to_job().bin_key for r in self.jobs})

    def to_json(self) -> str:
        return json.dumps(_enc(asdict(self)))

    @classmethod
    def from_json(cls, s: str) -> "InvocationPayload":
        d = _dec(json.loads(s))
        return cls(invocation_id=d["invocation_id"],
                   jobs=tuple(JobRef(**j) for j in d["jobs"]),
                   versions=tuple(VersionRef(**v) for v in d["versions"]),
                   bands=tuple(ForecastBlob(**b) for b in d.get("bands", ())),
                   created_at=d["created_at"], attempt=d["attempt"],
                   trace=d.get("trace"))


@dataclass(frozen=True)
class JobOutcome:
    ref: JobRef
    ok: bool
    duration_s: float
    error: str = ""
    attempts: int = 1


@dataclass(frozen=True)
class InvocationResult:
    """What comes back over the wire: per-job outcomes, artifacts produced
    by the action (versions from train jobs, forecasts from score jobs —
    empty for backends that persist directly into the shared stores), and
    the telemetry the monitor aggregates."""
    invocation_id: str
    worker_id: str
    cold_start: bool
    started_at: float                 # wall clock: queue latency = started - created
    finished_at: float
    outcomes: Tuple[JobOutcome, ...]
    versions: Tuple[VersionRef, ...] = ()
    forecasts: Tuple[ForecastBlob, ...] = ()
    detections: Tuple[DetectionBlob, ...] = ()
    # spans the worker process finished while executing this invocation
    # (plain dicts from Tracer.export_since) — the invoker absorbs them
    # into its own tracer to stitch one cross-process trace; empty for
    # backends whose workers share the invoker's tracer (inline)
    spans: Tuple[Dict[str, Any], ...] = ()

    def to_json(self) -> str:
        return json.dumps(_enc(asdict(self)))

    @classmethod
    def from_json(cls, s: str) -> "InvocationResult":
        d = _dec(json.loads(s))
        return cls(
            invocation_id=d["invocation_id"], worker_id=d["worker_id"],
            cold_start=d["cold_start"], started_at=d["started_at"],
            finished_at=d["finished_at"],
            outcomes=tuple(JobOutcome(ref=JobRef(**o.pop("ref")), **o)
                           for o in d["outcomes"]),
            versions=tuple(VersionRef(**v) for v in d["versions"]),
            forecasts=tuple(ForecastBlob(**f) for f in d["forecasts"]),
            detections=tuple(DetectionBlob(**x)
                             for x in d.get("detections", ())),
            spans=tuple(d.get("spans", ())))


#: process-wide intern table for affinity keys: the invoker's routing
#: dict is keyed by these dense ints, so steady-state routing of a bin
#: it has seen before is one tuple hash (here) + one int lookup — no
#: per-poll digesting of member-name strings
AFFINITY_KEYS = InternTable()


def affinity_key(bin_jobs: List[Job]) -> int:
    """Sticky-routing key for one bin — an INTERNED dense int — deciding
    which warm container its work should land on. The interned value
    excludes ``scheduled_at`` and ``task`` (unlike ``Job.bin_key``) so
    catch-up occurrences, successive polls, and the train/score halves of
    ONE logical bin all map to the same int — the worker's warm
    ``FleetRuntime`` state and its train->score device-param handoff are
    keyed by exactly (deployment set, params), which is what the sorted
    member tuple pins. Ids never cross processes; payloads ship names."""
    j0 = bin_jobs[0]
    return AFFINITY_KEYS.intern(
        (j0.package, j0.version, j0.user_params_key,
         tuple(sorted(j.deployment_name for j in bin_jobs))))
