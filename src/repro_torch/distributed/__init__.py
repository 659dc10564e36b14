"""Checkpointing and fault tolerance for one card (sharding, compression
and ``elastic_remesh`` wait for the multi-GPU slice)."""
from .checkpoint import CheckpointManager, save, restore, latest_step  # noqa: F401
from .fault import (HealthMonitor, NodeFailure, SupervisorReport,  # noqa: F401
                    TrainSupervisor, largest_mesh_shape)
