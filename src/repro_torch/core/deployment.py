"""Model deployments (paper §3.2, Listing 2) + programmatic fleet deployment.

A deployment binds (implementation, semantic context, schedules, user params,
rank). ``deploy_for_all`` implements the paper's key scaling feature:
explore the semantic graph and deploy an implementation to every matching
context, so the application grows as sensors are added.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from .scheduler import Schedule


@dataclass
class ModelDeployment:
    name: str                       # unique deployment name
    package: str                    # implementation reference
    model_class: str = ""           # informational (class name)
    version: Optional[str] = None   # None = latest at execution time
    signal: str = ""
    entity: str = ""
    train: Optional[Schedule] = None
    score: Optional[Schedule] = None
    user_params: Dict = field(default_factory=dict)
    rank: int = 0                   # paper's model-ranking mechanism (0 = best)
    # ---- flow typing ----
    # "forecast" deployments train/score as always; other flow kinds (the
    # minutely "detection" flow in flows/) schedule different tasks
    # against the same context. Indexed by DeploymentStore.for_flow.
    flow: str = "forecast"
    detect: Optional[Schedule] = None

    def to_json(self) -> str:
        d = asdict(self)
        return json.dumps(d, indent=2, default=str)

    @property
    def context_key(self):
        return (self.signal, self.entity)


def _schedule_record(s: Optional[Schedule]):
    return None if s is None else [s.start, s.every]


def _schedule_from(v) -> Optional[Schedule]:
    return None if v is None else Schedule(float(v[0]), float(v[1]))


def deployment_record(dep: ModelDeployment) -> Dict:
    """WAL/snapshot payload for one deployment. ``cls`` discriminates the
    dataclass to rebuild (``DetectionDeployment`` subclasses add nothing
    beyond a different flow default, but keep the type round-trip exact)."""
    return {"cls": type(dep).__name__, "name": dep.name,
            "package": dep.package, "model_class": dep.model_class,
            "version": dep.version, "signal": dep.signal,
            "entity": dep.entity, "train": _schedule_record(dep.train),
            "score": _schedule_record(dep.score),
            "detect": _schedule_record(dep.detect),
            "user_params": dep.user_params, "rank": dep.rank,
            "flow": dep.flow}


def deployment_from_record(d: Dict) -> ModelDeployment:
    cls = ModelDeployment
    if d.get("cls") == "DetectionDeployment":
        from ..flows.detection import DetectionDeployment
        cls = DetectionDeployment
    return cls(
        name=d["name"], package=d["package"],
        model_class=d.get("model_class", ""), version=d.get("version"),
        signal=d.get("signal", ""), entity=d.get("entity", ""),
        train=_schedule_from(d.get("train")),
        score=_schedule_from(d.get("score")),
        detect=_schedule_from(d.get("detect")),
        user_params=dict(d.get("user_params") or {}),
        rank=int(d.get("rank", 0)),
        flow=d.get("flow", "forecast"))


class DeploymentStore:
    """Indexed deployment registry: by name, by context ``(signal,
    entity)`` and by package, with a monotonically increasing
    ``revision`` and a listener protocol (``on_register(dep)`` /
    ``on_remove(name)``) so downstream caches — the scheduler's calendar
    queue above all — invalidate INCREMENTALLY on changes instead of
    re-scanning or re-sorting the fleet each poll. Context and package
    lookups are index hits proportional to their result size, never a
    fleet scan."""

    def __init__(self):
        self._deps: Dict[str, ModelDeployment] = {}
        self._sorted: Optional[List[ModelDeployment]] = None
        self._by_context: Dict[tuple, Dict[str, ModelDeployment]] = {}
        self._by_package: Dict[str, Dict[str, ModelDeployment]] = {}
        self._by_flow: Dict[str, Dict[str, ModelDeployment]] = {}
        self._revision = 0
        self._listeners: List = []
        self.journal = None           # durability.Journal when Castor.open'd

    @property
    def revision(self) -> int:
        """Bumped on every register/remove: consumers holding derived
        state (sorted views, routing tables) compare-and-refresh against
        this instead of diffing the fleet."""
        return self._revision

    def subscribe(self, listener) -> None:
        """Register a mutation listener: ``listener.on_register(dep)``
        after each registration, ``listener.on_remove(name)`` after each
        removal. The scheduler subscribes itself to keep its calendar
        queue and per-deployment state exactly in sync with the store."""
        self._listeners.append(listener)

    def register(self, dep: ModelDeployment) -> ModelDeployment:
        if dep.name in self._deps:
            raise ValueError(f"deployment {dep.name} already registered")
        self._deps[dep.name] = dep
        self._by_context.setdefault(dep.context_key, {})[dep.name] = dep
        self._by_package.setdefault(dep.package, {})[dep.name] = dep
        self._by_flow.setdefault(
            getattr(dep, "flow", "forecast"), {})[dep.name] = dep
        self._sorted = None
        self._revision += 1
        j = self.journal
        if j is not None:
            j.append("dep", deployment_record(dep))
        for sub in self._listeners:
            sub.on_register(dep)
        return dep

    def remove(self, name: str):
        dep = self._deps.pop(name, None)
        if dep is None:
            return
        for index, key in ((self._by_context, dep.context_key),
                           (self._by_package, dep.package),
                           (self._by_flow, getattr(dep, "flow", "forecast"))):
            bucket = index.get(key)
            if bucket is not None:
                bucket.pop(name, None)
                if not bucket:
                    del index[key]
        self._sorted = None
        self._revision += 1
        j = self.journal
        if j is not None:
            j.append("rmdep", {"name": name})
        for sub in self._listeners:
            sub.on_remove(name)

    def get(self, name: str) -> ModelDeployment:
        return self._deps[name]

    def __contains__(self, name: str) -> bool:
        return name in self._deps

    def all(self) -> List[ModelDeployment]:
        # bulk consumers (benchmark sweeps, deploy_for_all audits) get a
        # cached sort, invalidated by revision bumps — the scheduler no
        # longer calls this per poll at all
        if self._sorted is None:
            self._sorted = sorted(self._deps.values(), key=lambda d: d.name)
        return list(self._sorted)

    def for_context(self, signal: str, entity: str) -> List[ModelDeployment]:
        """All models deployed against one context, rank-sorted (Fig. 5).
        Index hit: O(models on that context), not O(fleet)."""
        out = self._by_context.get((signal, entity), {})
        return sorted(out.values(), key=lambda d: (d.rank, d.name))

    def for_package(self, package: str) -> List[ModelDeployment]:
        """All deployments of one implementation package, name-sorted
        (index hit — e.g. 'which fleets does retiring this package
        strand?')."""
        out = self._by_package.get(package, {})
        return sorted(out.values(), key=lambda d: d.name)

    def for_flow(self, flow: str) -> List[ModelDeployment]:
        """All deployments of one flow kind ("forecast", "detection", ...),
        name-sorted (index hit, not a fleet scan)."""
        out = self._by_flow.get(flow, {})
        return sorted(out.values(), key=lambda d: d.name)

    def flow_counts(self) -> Dict[str, int]:
        """Per-flow deployment counts for ``Castor.stats()``."""
        return {flow: len(bucket)
                for flow, bucket in sorted(self._by_flow.items()) if bucket}

    def __len__(self):
        return len(self._deps)


def deploy_for_all(graph, deployments: DeploymentStore, *, package: str,
                   signal: str, name_prefix: str,
                   train: Optional[Schedule] = None,
                   score: Optional[Schedule] = None,
                   user_params: Optional[dict] = None,
                   version: Optional[str] = None,
                   kind: Optional[str] = None,
                   under: Optional[str] = None,
                   rank: int = 0) -> List[ModelDeployment]:
    """Programmatic deployment from a semantic rule (paper §3.2):
    one deployment per entity that carries ``signal`` (optionally filtered by
    entity kind / topology).

    Incremental and idempotent: re-running the same rule after new
    entities were linked (the paper's "automated replication as the IoT
    application grows") deploys ONLY the not-yet-deployed contexts and
    returns just those new deployments — already-registered names are
    left untouched (their schedules/params are not rewritten), so a
    periodic re-apply of the rule is safe."""
    out = []
    for ent in graph.find_entities(kind=kind, has_signal=signal, under=under):
        name = f"{name_prefix}-{ent.name}"
        if name in deployments:        # already applied to this context
            prev = deployments.get(name)
            if (prev.package, prev.version, prev.signal, prev.entity,
                    prev.train, prev.score, prev.rank, prev.user_params) \
                    != (package, version, signal, ent.name, train, score,
                        rank, dict(user_params or {})):
                # same name, DIFFERENT rule (package, version, schedules,
                # params, or rank changed): skipping silently would leave
                # the caller believing the re-configured fleet exists —
                # the old loud-collision behavior is the right one here
                raise ValueError(
                    f"deployment {name} already registered with a "
                    f"different configuration ({prev.package}=="
                    f"{prev.version}/{prev.signal}); re-apply the "
                    "identical rule, or use a different name_prefix")
            continue
        dep = ModelDeployment(
            name=name,
            package=package, version=version, signal=signal, entity=ent.name,
            train=train, score=score, user_params=dict(user_params or {}),
            rank=rank)
        out.append(deployments.register(dep))
    return out
