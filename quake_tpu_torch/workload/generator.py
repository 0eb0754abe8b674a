"""Dynamic workload generation from a static dataset.

The counterpart of quake_tpu/workload/generator.py. Mirrors the reference
DynamicWorkloadGenerator (src/python/workload_generator.py:127-385):
cluster the base vectors, sample insert/delete/query operations by ratios
with a uniform or stratified (drifting) cluster sampler, compute
incremental ground truth per query op over the resident set, and persist
operations + runbook.json + a resident-history heatmap. Artifacts are .npy
instead of .pt.

Given the same seed and base vectors, the operations, ground truth,
initial indices and runbook (but for the wall-clock `gt_time`) equal the
JAX package's under a uniform cluster sample distribution: they depend only
on the numpy generator and the numpy oracle. The clustering index, a
QuakeWrapper of this package, lives on `device` (None = the CUDA card).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

from quake_tpu_torch.utils import knn


class VectorSampler:
    def sample(self, sample_pool: np.ndarray, size: int, update_ranks: bool = True):
        raise NotImplementedError


class UniformSampler(VectorSampler):
    """Uniform sampling (workload_generator.py:47-56)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def sample(self, sample_pool: np.ndarray, size: int, update_ranks: bool = True):
        size = min(size, len(sample_pool))
        return self.rng.permutation(sample_pool)[:size]


class StratifiedClusterSampler(VectorSampler):
    """Skewed, drifting sampling by cluster rank
    (workload_generator.py:60-124): walk clusters in nearest-first order from
    a drifting root cluster."""

    def __init__(self, assignments: np.ndarray, centroids: np.ndarray,
                 rng: Optional[np.random.Generator] = None):
        self.assignments = np.asarray(assignments)
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.rng = rng or np.random.default_rng()
        non_empty = np.unique(self.assignments)
        self.root_cluster = int(self.rng.choice(non_empty))
        self.cluster_ranks = None
        self.update_ranks(self.root_cluster)

    def update_ranks(self, root_cluster: int):
        self.root_cluster = int(root_cluster)
        ids, _ = knn(
            self.centroids[self.root_cluster][None, :],
            self.centroids,
            len(self.centroids),
            "l2",
        )
        self.cluster_ranks = ids.flatten()

    def sample(self, sample_pool: np.ndarray, size: int, update_ranks: bool = True):
        sample_assignments = self.assignments[sample_pool]
        present = set(np.unique(sample_assignments).tolist())
        order = [c for c in self.cluster_ranks.tolist() if c in present]
        out = []
        collected = 0
        for cluster in order:
            members = sample_pool[sample_assignments == cluster]
            if len(members) == 0:
                continue
            take = min(size - collected, len(members))
            out.append(self.rng.permutation(members)[:take])
            collected += take
            if collected >= size:
                break
        if update_ranks and len(order) > 1:
            self.update_ranks(order[1])
        if not out:
            return np.array([], dtype=np.int64)
        return np.unique(np.concatenate(out))


class DynamicWorkloadGenerator:
    """See module docstring. Construction signature mirrors the reference
    (workload_generator.py:136-156), with `device` added."""

    assign_batch = 65536  # base vectors a parent search in initialize_clustered_index

    def __init__(
        self,
        workload_dir: Union[str, Path],
        base_vectors: np.ndarray,
        metric: str,
        insert_ratio: float,
        delete_ratio: float,
        query_ratio: float,
        update_batch_size: int,
        query_batch_size: int,
        number_of_operations: int,
        initial_size: int,
        cluster_size: int,
        cluster_sample_distribution: str,
        queries: Optional[np.ndarray] = None,
        query_cluster_sample_distribution: str = "uniform",
        seed: int = 1738,
        initial_clustering_path: Optional[Union[str, Path]] = None,
        overwrite: bool = False,
        gt_k: int = 100,
        device=None,
    ):
        self.workload_dir = Path(workload_dir)
        self.base_vectors = np.asarray(base_vectors, dtype=np.float32)
        self.metric = metric.lower()
        self.insert_ratio = insert_ratio
        self.delete_ratio = delete_ratio
        self.query_ratio = query_ratio
        self.update_batch_size = update_batch_size
        self.query_batch_size = query_batch_size
        self.number_of_operations = number_of_operations
        self.initial_size = initial_size
        self.cluster_size = cluster_size
        self.cluster_sample_distribution = cluster_sample_distribution
        self.query_cluster_sample_distribution = query_cluster_sample_distribution
        self.queries = None if queries is None else np.asarray(queries, dtype=np.float32)
        self.seed = seed
        self.gt_k = gt_k
        self.device = device
        self.initial_clustering_path = (
            Path(initial_clustering_path) if initial_clustering_path else None
        )
        self.rng = np.random.default_rng(seed)
        self.validate_parameters()
        self.workload_dir.mkdir(parents=True, exist_ok=True)
        self.operations_dir = self.workload_dir / "operations"
        self.operations_dir.mkdir(parents=True, exist_ok=True)
        self.resident_set = np.zeros(len(self.base_vectors), dtype=bool)
        self.all_ids = np.arange(len(self.base_vectors), dtype=np.int64)
        self.assignments = None
        self.runbook: dict = {}
        self.clustered_index = None
        self.sampler = None
        self.query_sampler = None
        self.resident_history = []

    def workload_exists(self) -> bool:
        return (self.workload_dir / "runbook.json").exists()

    def validate_parameters(self):
        assert self.metric in ("l2", "ip")
        assert 0 <= self.insert_ratio <= 1
        assert 0 <= self.delete_ratio <= 1
        assert 0 <= self.query_ratio <= 1
        assert abs(self.insert_ratio + self.delete_ratio + self.query_ratio - 1.0) < 1e-9
        assert self.update_batch_size > 0 and self.query_batch_size > 0
        assert self.number_of_operations > 0 and self.initial_size > 0
        assert self.cluster_size > 0
        assert self.cluster_sample_distribution in ("uniform", "skewed", "skewed_fixed")

    def initialize_clustered_index(self):
        """workload_generator.py:207-229: cluster the base vectors once and
        keep the assignments for stratified sampling."""
        from quake_tpu_torch import SearchParams
        from quake_tpu_torch.wrappers.quake import QuakeWrapper

        index_dir = self.initial_clustering_path or (
            self.workload_dir / "clustered_index.bin"
        )
        index = QuakeWrapper(device=self.device)
        if Path(index_dir).exists():
            index.load(index_dir)
        else:
            n_clusters = max(len(self.base_vectors) // self.cluster_size, 2)
            index.build(
                self.base_vectors,
                nc=n_clusters,
                metric=self.metric,
                ids=self.all_ids,
            )
            index.save(str(index_dir))
        # The nearest centroid of every base vector, in batches of
        # assign_batch rows: rows are independent, so the ids equal those of
        # one search over the whole pool, without its [n, nlist] scores.
        sp = SearchParams(k=1, batched_scan=True)
        n = len(self.base_vectors)
        self.assignments = np.concatenate([
            index.index.parent.search(self.base_vectors[s:s + self.assign_batch], sp).ids
            for s in range(0, n, self.assign_batch)]).flatten()
        return index

    def sample(self, size: int, operation_type: str) -> np.ndarray:
        if operation_type == "insert":
            pool = self.all_ids[~self.resident_set]
        elif operation_type == "delete":
            pool = self.all_ids[self.resident_set]
        elif operation_type == "query":
            pool = (
                np.arange(len(self.queries), dtype=np.int64)
                if self.queries is not None
                else self.all_ids[~self.resident_set]
            )
        else:
            raise ValueError(f"Invalid operation type {operation_type}.")
        if len(pool) == 0:
            return np.array([], dtype=np.int64)
        sampler = self.sampler if operation_type in ("insert", "delete") else self.query_sampler
        return sampler.sample(pool, size)

    def initialize_workload(self):
        cents = self.clustered_index.centroids()
        if self.cluster_sample_distribution in ("skewed", "skewed_fixed"):
            self.sampler = StratifiedClusterSampler(self.assignments, cents, self.rng)
        else:
            self.sampler = UniformSampler(self.rng)
        if self.query_cluster_sample_distribution in ("skewed", "skewed_fixed"):
            q_assign, _ = knn(self.queries, cents, 1, "l2")
            self.query_sampler = StratifiedClusterSampler(
                q_assign.flatten(), cents, self.rng
            )
        else:
            self.query_sampler = UniformSampler(self.rng)

        initial = self.sample(self.initial_size, "insert")
        self.resident_set[initial] = True
        np.save(self.workload_dir / "initial_indices.npy", initial)
        np.save(self.workload_dir / "base_vectors.npy", self.base_vectors)
        if self.queries is not None:
            np.save(self.workload_dir / "query_vectors.npy", self.queries)
        self.runbook["parameters"] = {
            "sample_queries": self.queries is None,
            "n_base_vectors": int(len(self.base_vectors)),
            "vector_dimension": int(self.base_vectors.shape[1]),
            "metric": self.metric,
            "insert_ratio": self.insert_ratio,
            "delete_ratio": self.delete_ratio,
            "query_ratio": self.query_ratio,
            "update_batch_size": self.update_batch_size,
            "query_batch_size": self.query_batch_size,
            "number_of_operations": self.number_of_operations,
            "initial_size": self.initial_size,
            "cluster_size": self.cluster_size,
            "cluster_sample_distribution": self.cluster_sample_distribution,
            "query_cluster_sample_distribution": self.query_cluster_sample_distribution,
            "seed": self.seed,
        }
        self.runbook["initialize"] = {"size": self.initial_size}
        self.runbook["operations"] = {}

    def generate_workload(self):
        """workload_generator.py:294-385."""
        self.clustered_index = self.initialize_clustered_index()
        self.initialize_workload()
        n_inserts = n_deletes = n_queries = 0
        n_operations = 0

        n_clusters = int(self.assignments.max()) + 1
        all_sizes = np.bincount(self.assignments, minlength=n_clusters).astype(float)

        for i in range(self.number_of_operations):
            op = self.rng.choice(
                ["insert", "delete", "query"],
                p=[self.insert_ratio, self.delete_ratio, self.query_ratio],
            )
            size = self.update_batch_size if op != "query" else self.query_batch_size
            sample_ids = self.sample(size, op)
            if len(sample_ids) == 0:
                break
            n_operations = i + 1
            if op == "insert":
                self.resident_set[sample_ids] = True
                n_inserts += 1
            elif op == "delete":
                self.resident_set[sample_ids] = False
                n_deletes += 1
            else:
                n_queries += 1
            n_resident = int(self.resident_set.sum())
            if n_resident < 5 * self.update_batch_size:
                break
            entry = {"type": op, "sample_size": int(len(sample_ids)), "n_resident": n_resident}
            np.save(self.operations_dir / f"{i}.npy", sample_ids)
            if op == "query":
                queries = (
                    self.queries[sample_ids]
                    if self.queries is not None
                    else self.base_vectors[sample_ids]
                )
                t0 = time.time()
                resident_ids = self.all_ids[self.resident_set]
                gt_ids, gt_dists = knn(
                    queries,
                    self.base_vectors[resident_ids],
                    min(self.gt_k, n_resident),
                    self.metric,
                    ids=resident_ids,
                )
                entry["gt_time"] = time.time() - t0
                np.save(self.operations_dir / f"{i}_gt_ids.npy", gt_ids)
                np.save(self.operations_dir / f"{i}_gt_dists.npy", gt_dists)
            self.runbook["operations"][i] = entry

            fractions = np.zeros(n_clusters)
            resident_assign = self.assignments[self.resident_set]
            uniq, counts = np.unique(resident_assign, return_counts=True)
            fractions[uniq] = counts / np.maximum(all_sizes[uniq], 1)
            self.resident_history.append(fractions)

        self.runbook["summary"] = {
            "n_inserts": n_inserts,
            "n_deletes": n_deletes,
            "n_queries": n_queries,
            "n_operations": n_operations,
        }
        self._save_heatmap()
        with open(self.workload_dir / "runbook.json", "w") as f:
            json.dump(self.runbook, f, indent=4)

    def _save_heatmap(self):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        if not self.resident_history:
            return
        heatmap = np.array(self.resident_history).T
        fig, ax = plt.subplots(figsize=(10, 6))
        cax = ax.imshow(heatmap, cmap="viridis", aspect="auto")
        ax.set_xlabel("Operation Number")
        ax.set_ylabel("Cluster ID")
        fig.colorbar(cax, label="Resident Fraction")
        plt.tight_layout()
        plt.savefig(self.workload_dir / "resident_history.png")
        plt.close(fig)
