"""Parameter objects for quake_tpu_torch.

A copy of quake_tpu/params.py (the port imports nothing of the JAX package):
the same field names and defaults, mirroring the reference parameter surface
(src/cpp/include/common.h:69-184). Where this package treats a field
otherwise than the JAX package, ROADMAP.md lists it as a deviation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional
from dataclasses import dataclass


DEFAULT_NLIST = 0
DEFAULT_NITER = 5
DEFAULT_METRIC = "l2"
DEFAULT_NUM_WORKERS = 0

DEFAULT_K = 1
DEFAULT_NPROBE = 1
DEFAULT_RECALL_TARGET = -1.0
DEFAULT_BATCHED_SCAN = None
DEFAULT_PRECOMPUTED = True
DEFAULT_INITIAL_SEARCH_FRACTION = 0.02
DEFAULT_RECOMPUTE_THRESHOLD = 0.001
DEFAULT_APS_FLUSH_PERIOD_US = 100

DEFAULT_MAINTENANCE_POLICY = "query_cost"
DEFAULT_WINDOW_SIZE = 1000
DEFAULT_REFINEMENT_RADIUS = 25
DEFAULT_REFINEMENT_ITERATIONS = 3
DEFAULT_MIN_PARTITION_SIZE = 32
DEFAULT_ALPHA = 0.9
DEFAULT_ENABLE_SPLIT_REJECTION = True
DEFAULT_ENABLE_DELETE_REJECTION = True
DEFAULT_DELETE_THRESHOLD_NS = 10.0
DEFAULT_SPLIT_THRESHOLD_NS = 10.0

DEFAULT_LATENCY_ESTIMATOR_RANGE_N = [1, 2, 4, 16, 64, 256, 1024, 4096, 16384, 65536]
DEFAULT_LATENCY_ESTIMATOR_RANGE_K = [1, 4, 16, 64, 256]
DEFAULT_LATENCY_ESTIMATOR_NTRIALS = 5

VALID_METRICS = ("l2", "ip")


def check_metric(metric: str) -> str:
    """Normalize/validate a metric string (reference common.h:145-156)."""
    m = metric.lower()
    if m not in VALID_METRICS:
        raise ValueError(f"Invalid metric type: {metric!r} (expected 'l2' or 'ip')")
    return m


@dataclass
class MaintenancePolicyParams:
    """Mirrors reference MaintenancePolicyParams (common.h:104-118)."""

    maintenance_policy: str = DEFAULT_MAINTENANCE_POLICY
    window_size: int = DEFAULT_WINDOW_SIZE
    refinement_radius: int = DEFAULT_REFINEMENT_RADIUS
    refinement_iterations: int = DEFAULT_REFINEMENT_ITERATIONS
    min_partition_size: int = DEFAULT_MIN_PARTITION_SIZE
    alpha: float = DEFAULT_ALPHA
    enable_split_rejection: bool = DEFAULT_ENABLE_SPLIT_REJECTION
    enable_delete_rejection: bool = DEFAULT_ENABLE_DELETE_REJECTION
    delete_threshold_ns: float = DEFAULT_DELETE_THRESHOLD_NS
    split_threshold_ns: float = DEFAULT_SPLIT_THRESHOLD_NS


@dataclass
class IndexBuildParams:
    """Mirrors reference IndexBuildParams (common.h:123-143).

    Extensions beyond the reference:
      precision: stored code dtype, "f32" or "bf16" (the parent's through
        parent_params, whose bf16 codes kernel K3 ranks on its bf16 body).
      num_shards: shard the store over this many mesh devices at the end of
        the build (QuakeIndex.shard; 0 or 1 = one device): the first
        num_shards CUDA cards (as many as there are), or on a CPU index
        num_shards virtual CPU shards. num_workers > 1 shards likewise,
        but only where there are that many CUDA cards.
      spill, soar_lambda: SOAR spilled assignment (ScaNN, NeurIPS'23):
        every vector also in a second partition chosen by
        kmeans.soar_assign (soar_lambda weights the residuals'
        orthogonality); searches drop the second copy of an id.
    """

    dimension: int = 0
    nlist: int = DEFAULT_NLIST
    num_workers: int = DEFAULT_NUM_WORKERS
    code_size: int = -1  # reserved for PQ (unimplemented in reference too)
    num_codebooks: int = -1
    metric: str = DEFAULT_METRIC
    niter: int = DEFAULT_NITER

    use_adaptive_nprobe: bool = False
    use_numa: bool = False  # accepted for API parity; no-op
    use_gpu: bool = False  # accepted for API parity; no-op
    verify_numa: bool = False
    same_core: bool = True
    verbose: bool = False

    parent_params: "IndexBuildParams | None" = None

    precision: str = "f32"
    num_shards: int = 0
    balance_partitions: bool = True
    spill: bool = False
    soar_lambda: float = 1.0
    balance_factor: float = 1.5
    calibrate_aps: bool = True
    profile_maintenance_latency: bool = False
    mutation_buffer_size: int = 0


@dataclass
class SearchParams:
    """Mirrors reference SearchParams (common.h:171-184).

    `num_threads`, `aps_flush_period_us` are accepted for API parity and are
    no-ops. A `recall_target` above 0 runs recall-target (APS) search on an
    IVF index; the `aps_*` fields tune it: `aps_mode` picks the strategy
    ("auto", "dense", "oneshot", "planned", "loop"; QuakeIndex.search),
    `aps_chunk_size` the loop's step and the planned prologue (0 = auto),
    `aps_plan_margin` the ranks a plan adds before its rounding.
    `exact_distances` False serves v10/v11 distances from the scan's keys.
    """

    nprobe: int = DEFAULT_NPROBE
    k: int = DEFAULT_K
    recall_target: float = DEFAULT_RECALL_TARGET
    num_threads: int = 1
    k_factor: float = 1.0
    use_precomputed: bool = DEFAULT_PRECOMPUTED
    batched_scan: Optional[bool] = DEFAULT_BATCHED_SCAN
    recompute_threshold: float = DEFAULT_RECOMPUTE_THRESHOLD
    initial_search_fraction: Optional[float] = None
    aps_flush_period_us: int = DEFAULT_APS_FLUSH_PERIOD_US

    aps_chunk_size: int = 0
    aps_mode: str = "auto"
    aps_plan_margin: int = 4
    exact_distances: bool = True

    def copy(self) -> "SearchParams":
        return dataclasses.replace(self)
