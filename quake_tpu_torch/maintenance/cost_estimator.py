"""Cost deltas for split and delete maintenance decisions (the counterpart of
quake_tpu/maintenance/cost_estimator.py).

The reference MaintenanceCostEstimator's arithmetic
(src/cpp/src/maintenance_cost_estimator.cpp:384-493) over the latency model.
Deltas are in nanoseconds; negative means beneficial.
"""

from __future__ import annotations

import numpy as np

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

    def _L(self, n):
        return self.latency_estimator.estimate_scan_latency_array(n, self.k)

    def compute_split_delta(self, partition_size: int, hit_rate: float,
                            total_partitions: int) -> float:
        """maintenance_cost_estimator.cpp:384-394."""
        return float(self.compute_split_delta_array(partition_size, hit_rate, total_partitions))

    def compute_split_delta_array(self, sizes, hit_rates, total_partitions: int) -> np.ndarray:
        """compute_split_delta at every (size, hit rate) pair, to the bit."""
        sizes, hit_rates = np.asarray(sizes), np.asarray(hit_rates)
        L = self._L
        l_up, l_t = L(np.array([total_partitions + 1, total_partitions]))
        delta_overhead = l_up - l_t
        old_cost = L(sizes) * hit_rates
        new_cost = L(sizes / 2) * hit_rates * (2.0 * self.alpha)
        return delta_overhead + new_cost - old_cost

    def compute_delete_delta(self, partition_size: int, hit_rate: float,
                             total_partitions: int, avg_partition_hit_rate: float,
                             avg_partition_size: float) -> float:
        """maintenance_cost_estimator.cpp:397-454."""
        return float(self.compute_delete_delta_array(
            partition_size, hit_rate, total_partitions, avg_partition_hit_rate,
            avg_partition_size))

    def compute_delete_delta_array(self, sizes, hit_rates, total_partitions: int,
                                   avg_partition_hit_rate: float,
                                   avg_partition_size: float) -> np.ndarray:
        """compute_delete_delta at every (size, hit rate) pair, to the bit:
        the terms that do not depend on the partition are looked up once."""
        sizes, hit_rates = np.asarray(sizes), np.asarray(hit_rates)
        if total_partitions <= 1:
            return np.zeros(np.broadcast(sizes, hit_rates).shape)
        L = self._L
        T = total_partitions
        l_down, l_t, l_avg, l_avg1 = L(np.array(
            [T - 1, T, avg_partition_size, avg_partition_size + 1]))
        delta_overhead = l_down - l_t
        cost_old = (T - 1) * avg_partition_hit_rate * l_avg + hit_rates * L(sizes)
        merged_size = avg_partition_size + sizes / (T - 1)
        merged_hit_rate = avg_partition_hit_rate + hit_rates / (T - 1)
        cost_new = np.where(
            sizes < T,
            sizes * merged_hit_rate * l_avg1
            + (T - sizes - 1) * merged_hit_rate * l_avg,
            (T - 1) * merged_hit_rate * L(np.ceil(merged_size)),
        )
        return delta_overhead + (cost_new - cost_old)

    def compute_delete_delta_w_reassign(self, partition_size: int, hit_rate: float,
                                        total_partitions: int, reassign_counts,
                                        reassign_sizes, reassign_hit_rates) -> float:
        """maintenance_cost_estimator.cpp:456-493. The reassigned
        partitions' terms are summed in order (a cumulative sum), as the
        reference's loop adds them."""
        if total_partitions <= 1:
            return 0.0
        L = self._L
        l_down, l_t, l_size = L(np.array([total_partitions - 1, total_partitions, partition_size]))
        delta_overhead = l_down - l_t
        removal_delta = hit_rate * l_size
        sizes, hit_rates = np.asarray(reassign_sizes), np.asarray(reassign_hit_rates)
        terms = (hit_rates + hit_rate) * L(sizes + partition_size) - hit_rates * L(sizes)
        reassign_delta = float(np.cumsum(terms)[-1]) if terms.size else 0.0
        return float(delta_overhead + removal_delta + reassign_delta)
