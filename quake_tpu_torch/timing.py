"""Timing/result structures mirroring the reference's typed timing info.

A copy of quake_tpu/timing.py. Reference: src/cpp/include/common.h:189-247.
Every public op returns one of these, populated with host wall-clock stamps
around the device calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class BuildTimingInfo:
    """Reference common.h:189-198."""

    n_vectors: int = 0
    n_clusters: int = 0
    d: int = 0
    num_codebooks: int = -1
    code_size: int = -1
    train_time_us: int = 0
    assign_time_us: int = 0
    total_time_us: int = 0
    # Not in the JAX package: of train_time_us, the balancing's split rounds
    # (kmeans.balance_clusters); and the APS calibration (calibrate_aps),
    # ending in a sync on a card. 0 where the build skips the stage.
    balance_time_us: int = 0
    calibrate_time_us: int = 0


@dataclass
class ModifyTimingInfo:
    """Reference common.h:203-209."""

    n_vectors: int = 0
    input_validation_time_us: int = 0
    find_partition_time_us: int = 0
    modify_time_us: int = 0
    maintenance_time_us: int = 0


@dataclass
class SearchTimingInfo:
    """Reference common.h:214-228.

    The worker-queue phases collapse into one stream of device launches, so
    job_enqueue/job_wait map to (enqueue, device-execute) and the remaining
    counters are kept for API parity.
    """

    n_queries: int = 0
    n_clusters: int = 0
    partitions_scanned: int = 0
    search_params: Optional[Any] = None
    parent_info: Optional["SearchTimingInfo"] = None

    buffer_init_time_ns: int = 0
    job_enqueue_time_ns: int = 0
    boundary_distance_time_ns: int = 0
    job_wait_time_ns: int = 0
    result_aggregate_time_ns: int = 0
    total_time_ns: int = 0

    # Not in the JAX package: the steps of the APS loop (aps_mode="loop")
    # and the reads of its termination flag from the device (syncs), which
    # the JAX package's device-side while_loop does not need.
    aps_loop_steps: int = 0
    aps_loop_syncs: int = 0
    # Not in the JAX package: of a recall-target search, the partitions each
    # query scanned after the plan's clip and budget (int32 numpy [B], read
    # in the same copy as partitions_scanned, their mean), and the pair
    # budget the plan passed to the scan (0 for none).
    scanned_per_query: Optional[Any] = None
    aps_pair_budget: int = 0


@dataclass
class MaintenanceTimingInfo:
    """Reference common.h:233-241."""

    n_splits: int = 0
    n_deletes: int = 0
    delete_time_us: int = 0
    delete_refine_time_us: int = 0
    split_time_us: int = 0
    split_refine_time_us: int = 0
    total_time_us: int = 0


@dataclass
class SearchResult:
    """Reference common.h:243-247: ids [nq,k] int64, distances [nq,k] float32."""

    ids: Any = None
    distances: Any = None
    timing_info: Optional[SearchTimingInfo] = None
