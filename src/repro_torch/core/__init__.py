from .castor import Castor, Schedule, ModelDeployment, MINUTE, HOUR, DAY, WEEK  # noqa: F401
from .executor import FleetExecutor, LocalPoolExecutor, JobResult  # noqa: F401
from .registry import ModelInterface, ModelRegistry  # noqa: F401
from .semantics import Context, Entity, SemanticGraph, Signal  # noqa: F401
