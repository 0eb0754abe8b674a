"""Dynamic workloads (the counterpart of quake_tpu/workload/): generation
from a static dataset, and replay against an IndexWrapper."""

from quake_tpu_torch.workload.generator import (
    DynamicWorkloadGenerator,
    StratifiedClusterSampler,
    UniformSampler,
)
from quake_tpu_torch.workload.evaluator import WorkloadEvaluator

__all__ = [
    "DynamicWorkloadGenerator",
    "WorkloadEvaluator",
    "UniformSampler",
    "StratifiedClusterSampler",
]
