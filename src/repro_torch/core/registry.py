"""Model-implementation registry + the 4-function model interface (Listing 1).

An *implementation* is reusable code (load / transform / train / score); a
*deployment* (deployment.py) binds it to a semantic context and schedules.
The registry plays the paper's PyPI role: versioned artifacts, latest-wins
resolution, retrieval at execution time.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type

from .semantics import Context


class ModelInterface(abc.ABC):
    """Paper Listing 1. Subclasses implement load/transform/train/score.

    Runtime-populated attributes (transparently provided by the execution
    engine, §3.1): ``context``, ``task``, ``model_id``, ``model_version``,
    ``user_params``, ``system`` (data access: .store, .graph, .weather).
    """

    #: subclasses that support fleet (megabatched) execution set this True and
    #: implement the fleet_* classmethods below.
    SUPPORTS_FLEET = False

    def __init__(self, context: Context, task: str, model_id: str,
                 model_version: Optional[int], user_params: dict, system):
        self.context = context
        self.task = task
        self.model_id = model_id
        self.model_version = model_version
        self.user_params = dict(user_params or {})
        self.system = system

    @abc.abstractmethod
    def load(self):
        """Fetch raw data (semantic store, weather, ...)."""

    @abc.abstractmethod
    def transform(self):
        """Feature engineering on loaded data."""

    @abc.abstractmethod
    def train(self) -> Any:
        """Return a model object (fitted parameters + metadata)."""

    @abc.abstractmethod
    def score(self, model_object) -> Tuple[Any, Any]:
        """Return (times, values) prediction over the configured horizon."""

    # ---- optional fleet hooks (megabatched execution) ----
    # ``mesh``: optional 1-D fleet mesh (launch/mesh.make_fleet_mesh); when
    # given, the bin's instance axis is split over its devices. None = the
    # whole bin on the system's device, the same results.
    @classmethod
    def fleet_train(cls, instances: List["ModelInterface"], *, mesh=None):
        raise NotImplementedError

    @classmethod
    def fleet_score(cls, instances: List["ModelInterface"], model_objects, *,
                    mesh=None):
        raise NotImplementedError


@dataclass(frozen=True)
class ImplementationKey:
    package: str
    version: str

    def __str__(self):
        return f"{self.package}=={self.version}"


class ModelRegistry:
    """Versioned registry of implementation classes (the paper's PyPI)."""

    def __init__(self):
        self._impls: Dict[str, Dict[str, Type[ModelInterface]]] = {}

    def register(self, package: str, version: str,
                 cls: Type[ModelInterface]) -> ImplementationKey:
        assert issubclass(cls, ModelInterface), cls
        self._impls.setdefault(package, {})
        if version in self._impls[package]:
            raise ValueError(f"{package}=={version} already published "
                             "(artifacts are immutable)")
        self._impls[package][version] = cls
        return ImplementationKey(package, version)

    def get(self, package: str, version: Optional[str] = None) -> Type[ModelInterface]:
        versions = self._impls.get(package)
        if not versions:
            raise KeyError(f"package {package} not found")
        if version is None:
            version = max(versions, key=_version_key)
        return versions[version]

    def resolve_version(self, package: str, version: Optional[str] = None) -> str:
        versions = self._impls[package]
        return version if version is not None else max(versions, key=_version_key)

    def list(self) -> List[str]:
        return [f"{p}=={v}" for p, vs in sorted(self._impls.items())
                for v in sorted(vs, key=_version_key)]


def _version_key(v: str):
    try:
        return tuple(int(x) for x in v.split("."))
    except ValueError:
        return (0,), v
