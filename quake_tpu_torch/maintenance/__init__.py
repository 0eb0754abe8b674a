"""Cost-based maintenance (the counterpart of quake_tpu/maintenance/)."""

from quake_tpu_torch.maintenance.cost_estimator import MaintenanceCostEstimator
from quake_tpu_torch.maintenance.hit_tracker import HitCountTracker
from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator
from quake_tpu_torch.maintenance.policy import MaintenancePolicy

__all__ = [
    "HitCountTracker",
    "ListScanLatencyEstimator",
    "MaintenanceCostEstimator",
    "MaintenancePolicy",
]
