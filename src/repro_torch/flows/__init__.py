"""Flow-typed deployments: the hourly forecast flow and the minutely
detection flow (``DetectionDeployment``, idempotent ``DetectionStore``)."""
from .detection import (DetectionDeployment, DetectionRecord,
                        DetectionStore, deploy_detections_for_all)

__all__ = [
    "DetectionDeployment",
    "DetectionRecord",
    "DetectionStore",
    "deploy_detections_for_all",
]
