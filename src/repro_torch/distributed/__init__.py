"""Sharding (fleet bins over a fleet mesh; the LM layouts' rules as
DTensor placements and the moves between DTensors and whole tensors),
sharded and elastic checkpointing, int8 gradient compression with error
feedback, and fault tolerance (supervised restart, ``elastic_remesh``).
The train step on a mesh is ``launch.cells.make_sharded_train_step``."""
from .sharding import Rules, baseline_rules, make_shard_fn, param_shardings  # noqa: F401
from .checkpoint import CheckpointManager, save, restore, latest_step  # noqa: F401
from .compression import (FeedbackHook, compress_with_feedback,  # noqa: F401
                          init_error_state, quantize_int8, dequantize_int8,
                          wire_bytes_saved)
from .fault import (HealthMonitor, NodeFailure, SupervisorReport,  # noqa: F401
                    TrainSupervisor, elastic_remesh, largest_mesh_shape)
