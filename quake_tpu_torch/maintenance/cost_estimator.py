"""Cost deltas for split and delete maintenance decisions (the counterpart of
quake_tpu/maintenance/cost_estimator.py).

The reference MaintenanceCostEstimator's arithmetic
(src/cpp/src/maintenance_cost_estimator.cpp:384-493) over the latency model.
Deltas are in nanoseconds; negative means beneficial.
"""

from __future__ import annotations

import math

from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator


class MaintenanceCostEstimator:
    def __init__(self, d: int, alpha: float, k: int,
                 latency_estimator: ListScanLatencyEstimator | None = None, device=None):
        if k <= 0:
            raise ValueError("k must be positive")
        if alpha <= 0.0:
            raise ValueError("alpha must be positive")
        self.d = int(d)
        self.alpha = float(alpha)
        self.k = int(k)
        # Without a grid of its own: the packaged H100 grid for a CUDA
        # device, the analytic model elsewhere (ListScanLatencyEstimator's
        # packaged=None).
        self.latency_estimator = latency_estimator or ListScanLatencyEstimator(d, device=device)

    def compute_split_delta(self, partition_size: int, hit_rate: float,
                            total_partitions: int) -> float:
        """maintenance_cost_estimator.cpp:384-394."""
        L = self.latency_estimator.estimate_scan_latency
        delta_overhead = L(total_partitions + 1, self.k) - L(total_partitions, self.k)
        old_cost = L(partition_size, self.k) * hit_rate
        new_cost = L(partition_size / 2, self.k) * hit_rate * (2.0 * self.alpha)
        return delta_overhead + new_cost - old_cost

    def compute_delete_delta(self, partition_size: int, hit_rate: float,
                             total_partitions: int, avg_partition_hit_rate: float,
                             avg_partition_size: float) -> float:
        """maintenance_cost_estimator.cpp:397-454."""
        if total_partitions <= 1:
            return 0.0
        L = self.latency_estimator.estimate_scan_latency
        delta_overhead = L(total_partitions - 1, self.k) - L(total_partitions, self.k)

        cost_old = (
            (total_partitions - 1) * avg_partition_hit_rate * L(avg_partition_size, self.k)
            + hit_rate * L(partition_size, self.k)
        )
        merged_size = avg_partition_size + partition_size / (total_partitions - 1)
        merged_hit_rate = avg_partition_hit_rate + hit_rate / (total_partitions - 1)
        if partition_size < total_partitions:
            cost_new = (
                partition_size * merged_hit_rate * L(avg_partition_size + 1, self.k)
                + (total_partitions - partition_size - 1)
                * merged_hit_rate
                * L(avg_partition_size, self.k)
            )
        else:
            cost_new = (
                (total_partitions - 1)
                * merged_hit_rate
                * L(math.ceil(merged_size), self.k)
            )
        return delta_overhead + (cost_new - cost_old)

    def compute_delete_delta_w_reassign(self, partition_size: int, hit_rate: float,
                                        total_partitions: int, reassign_counts,
                                        reassign_sizes, reassign_hit_rates) -> float:
        """maintenance_cost_estimator.cpp:456-493."""
        if total_partitions <= 1:
            return 0.0
        L = self.latency_estimator.estimate_scan_latency
        delta_overhead = L(total_partitions - 1, self.k) - L(total_partitions, self.k)
        removal_delta = hit_rate * L(partition_size, self.k)
        reassign_delta = 0.0
        for sz, hr in zip(reassign_sizes, reassign_hit_rates):
            old = hr * L(sz, self.k)
            reassign_delta += (hr + hit_rate) * L(sz + partition_size, self.k) - old
        return delta_overhead + removal_delta + reassign_delta
