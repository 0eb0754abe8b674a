"""Workload replay + evaluation against any IndexWrapper.

The counterpart of quake_tpu/workload/evaluator.py. Mirrors the reference
WorkloadEvaluator (src/python/workload_generator.py:388-606):
per-operation latency, recall, index_state, optional maintenance after each
operation, summary printout and a 4-panel plot.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

from quake_tpu_torch.utils import compute_recall


class WorkloadEvaluator:
    def __init__(
        self,
        workload_dir: Union[str, Path],
        output_dir: Union[str, Path],
        base_vectors_path: Optional[Union[str, Path]] = None,
    ):
        self.workload_dir = Path(workload_dir)
        self.output_dir = Path(output_dir)
        self.runbook_path = self.workload_dir / "runbook.json"
        self.operations_dir = self.workload_dir / "operations"
        self.initial_indices_path = self.workload_dir / "initial_indices.npy"
        self.base_vectors_path = (
            Path(base_vectors_path)
            if base_vectors_path
            else self.workload_dir / "base_vectors.npy"
        )
        self.runbook = None

    def initialize_index(self, name, index, build_params, m_params=None):
        """workload_generator.py:409-428."""
        index_dir = self.workload_dir / "init_indexes"
        index_dir.mkdir(parents=True, exist_ok=True)
        index_path = index_dir / f"{name}.index"
        vectors = np.load(self.base_vectors_path).astype(np.float32)
        initial = np.load(self.initial_indices_path).astype(np.int64)
        if not index_path.exists():
            index.build(vectors[initial], ids=initial, **build_params)
            index.save(str(index_path))
        else:
            index.load(str(index_path), n_workers=build_params.get("num_workers", 0))

        from quake_tpu_torch.wrappers.quake import QuakeWrapper

        if isinstance(index, QuakeWrapper) and m_params is not None:
            index.index.initialize_maintenance_policy(m_params)
        return index

    def evaluate_workload(
        self,
        name,
        index,
        build_params,
        search_params,
        do_maintenance: bool = False,
        m_params=None,
        batch: bool = True,
    ):
        """workload_generator.py:430-606. Returns per-operation result dicts."""
        assert "k" in search_params, "search_params must contain 'k'"
        base_vectors = np.load(self.base_vectors_path).astype(np.float32)
        index = self.initialize_index(name, index, build_params, m_params)

        with open(self.runbook_path) as f:
            self.runbook = json.load(f)
        query_vectors = (
            base_vectors
            if self.runbook["parameters"]["sample_queries"]
            else np.load(self.workload_dir / "query_vectors.npy").astype(np.float32)
        )

        results = []
        for op_id, op in self.runbook["operations"].items():
            op_type = op["type"]
            op_ids = np.load(self.operations_dir / f"{op_id}.npy").astype(np.int64)
            mean_recall = None
            if op_type == "insert":
                t0 = time.time()
                index.add(base_vectors[op_ids], ids=op_ids)
                op_time = time.time() - t0
            elif op_type == "delete":
                t0 = time.time()
                index.remove(op_ids)
                op_time = time.time() - t0
            else:
                gt_ids = np.load(self.operations_dir / f"{op_id}_gt_ids.npy")
                queries = query_vectors[op_ids]
                t0 = time.time()
                if batch:
                    res = index.search(queries, **search_params)
                    pred_ids = np.asarray(res.ids)
                else:
                    pred_ids = np.concatenate(
                        [
                            np.asarray(index.search(q[None, :], **search_params).ids)
                            for q in queries
                        ]
                    )
                op_time = time.time() - t0
                mean_recall = compute_recall(pred_ids, gt_ids, search_params["k"])
                self.runbook["operations"][op_id]["recall"] = mean_recall

            # Maintenance is timed as its own column (the reference returns
            # MaintenanceTimingInfo per op, common.h:233-241) so the
            # regression gates can catch a maintenance-cost regression.
            maintenance_ms = None
            n_splits = n_deletes = None
            if do_maintenance:
                t0 = time.time()
                m_info = index.maintenance()
                maintenance_ms = (time.time() - t0) * 1000
                if m_info is not None:
                    n_splits = getattr(m_info, "n_splits", None)
                    n_deletes = getattr(m_info, "n_deletes", None)

            result = {
                "operation_number": int(op_id),
                "operation_type": op_type,
                "latency_ms": op_time * 1000,
                "recall": mean_recall,
                "n_resident": op.get("n_resident"),
                "maintenance_ms": maintenance_ms,
                "maintenance_splits": n_splits,
                "maintenance_deletes": n_deletes,
            }
            result.update(index.index_state())
            result.update(search_params)
            results.append(result)

        self._summarize(results)
        self._plot(results)
        return results

    def _summarize(self, results):
        def avg(vals):
            vals = [v for v in vals if v is not None]
            return float(np.mean(vals)) if vals else None

        summary = {
            "avg_insert_latency_ms": avg(
                [r["latency_ms"] for r in results if r["operation_type"] == "insert"]
            ),
            "avg_delete_latency_ms": avg(
                [r["latency_ms"] for r in results if r["operation_type"] == "delete"]
            ),
            "avg_query_latency_ms": avg(
                [r["latency_ms"] for r in results if r["operation_type"] == "query"]
            ),
            "avg_query_recall": avg(
                [r["recall"] for r in results if r["operation_type"] == "query"]
            ),
            "avg_maintenance_ms": avg(
                [r.get("maintenance_ms") for r in results]
            ),
        }
        print("\nWorkload Evaluation Summary:")
        for k, v in summary.items():
            if v is not None:
                print(f"  {k}: {v:.3f}")
        self.summary = summary

    def _plot(self, results):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        self.output_dir.mkdir(parents=True, exist_ok=True)
        fig, axs = plt.subplots(2, 2, figsize=(12, 10))
        for op, marker in (("insert", "o"), ("delete", "s"), ("query", "^")):
            pts = [
                (r["operation_number"], r["latency_ms"])
                for r in results
                if r["operation_type"] == op
            ]
            if pts:
                axs[0, 0].plot(*zip(*pts), label=op.capitalize(), marker=marker)
        axs[0, 0].set_xlabel("Operation Number")
        axs[0, 0].set_ylabel("Latency (ms)")
        axs[0, 0].set_title("Operation Latency")
        axs[0, 0].legend()

        parts = [
            (r["operation_number"], r["n_list"]) for r in results if r.get("n_list")
        ]
        if parts:
            axs[0, 1].plot(*zip(*parts), marker="o")
            axs[0, 1].set_title("Partitions per Operation")

        res_pts = [
            (r["operation_number"], r["n_resident"])
            for r in results
            if r.get("n_resident")
        ]
        if res_pts:
            axs[1, 0].plot(*zip(*res_pts), marker="o")
            axs[1, 0].set_title("Resident Set Size")

        rec_pts = [
            (r["operation_number"], r["recall"])
            for r in results
            if r["operation_type"] == "query" and r["recall"] is not None
        ]
        if rec_pts:
            axs[1, 1].plot(*zip(*rec_pts), marker="o")
            axs[1, 1].set_title("Query Recall")
        plt.tight_layout()
        plt.savefig(self.output_dir / "evaluation_plots.png")
        plt.close(fig)
