"""Sharding (fleet bins over a fleet mesh; the LM layouts' rules as
DTensor placements), checkpointing and fault tolerance. Sharded
checkpoints, compression and ``elastic_remesh`` wait for the slice that
trains across cards."""
from .checkpoint import CheckpointManager, save, restore, latest_step  # noqa: F401
from .fault import (HealthMonitor, NodeFailure, SupervisorReport,  # noqa: F401
                    TrainSupervisor, largest_mesh_shape)
