"""The port's dynamic-workload tooling (quake_tpu_torch/workload/) on the CPU.

The generator is held to the JAX package's: the same seed and base vectors
give the same files, byte for byte (operations, ground truth, initial
indices, vectors), and the same runbook but for the wall-clock gt_time.
The evaluator mirrors tests/test_workload.py and tests/test_misc.py on the
port's QuakeWrapper, and replays one workload from the initial index that
the JAX evaluator built and saved: n_total equal after every operation, and
each query operation's recall within 0.01 of the JAX run's (the port's CPU
scan is v11, the JAX package's "xla"; 20 queries at k=10 give recall in
steps of 0.005).
"""

import json

import numpy as np
import pytest

from quake_tpu.params import MaintenancePolicyParams as JaxMaintenancePolicyParams
from quake_tpu.workload.evaluator import WorkloadEvaluator as JaxWorkloadEvaluator
from quake_tpu.workload.generator import DynamicWorkloadGenerator as JaxGenerator
from quake_tpu.wrappers.quake import QuakeWrapper as JaxQuakeWrapper
from quake_tpu_torch.params import MaintenancePolicyParams
from quake_tpu_torch.workload import (DynamicWorkloadGenerator, StratifiedClusterSampler,
                                      UniformSampler, WorkloadEvaluator)
from quake_tpu_torch.wrappers.quake import QuakeWrapper

GEN = dict(metric="l2", insert_ratio=0.3, delete_ratio=0.2, query_ratio=0.5,
           update_batch_size=100, query_batch_size=20, number_of_operations=20,
           initial_size=2000, cluster_size=100, cluster_sample_distribution="uniform",
           seed=42)


def _base(n=10_000, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The workload of tests/test_workload.py::workload, generated by the port."""
    tmp = tmp_path_factory.mktemp("workload")
    gen = DynamicWorkloadGenerator(workload_dir=tmp, base_vectors=_base(), queries=None,
                                   device="cpu", **GEN)
    gen.generate_workload()
    return tmp


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*.npy")
                  if "clustered_index.bin" not in p.parts and "init_indexes" not in p.parts)


def _runbook(root):
    rb = json.loads((root / "runbook.json").read_text())
    for op in rb["operations"].values():
        op.pop("gt_time", None)
    return rb


@pytest.mark.parametrize("with_queries", [False, True], ids=["sampled_queries", "queries"])
def test_generator_matches_jax(tmp_path, with_queries):
    """Every .npy file equal byte for byte, the runbook equal but for
    gt_time, under a uniform distribution (with queries sampled from the
    base pool, and with a query set of their own)."""
    base = _base(6000, 8, seed=1)
    queries = _base(300, 8, seed=2) if with_queries else None
    kw = dict(GEN, number_of_operations=30, initial_size=1500, seed=7, queries=queries)
    JaxGenerator(workload_dir=tmp_path / "jax", base_vectors=base, **kw).generate_workload()
    gen = DynamicWorkloadGenerator(workload_dir=tmp_path / "torch", base_vectors=base,
                                   device="cpu", **kw)
    gen.generate_workload()
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "torch")
    assert any(f.name.endswith("_gt_ids.npy") for f in files)
    names = {f.name for f in files}
    assert "initial_indices.npy" in names and ("query_vectors.npy" in names) == with_queries
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes(), f
    assert _runbook(tmp_path / "jax") == _runbook(tmp_path / "torch")
    assert gen.assignments.shape == (6000,) and gen.assignments.max() < 6000 // 100


def test_clustering_in_batches(tmp_path):
    """The clustering index's assignments searched in batches equal one
    search over the whole pool."""
    base = _base(3000, 8, seed=3)
    gen = DynamicWorkloadGenerator(workload_dir=tmp_path, base_vectors=base, device="cpu",
                                   **dict(GEN, initial_size=500))
    gen.assign_batch = 700
    index = gen.initialize_clustered_index()
    from quake_tpu_torch import SearchParams

    whole = index.index.parent.search(base, SearchParams(k=1, batched_scan=True)).ids
    np.testing.assert_array_equal(gen.assignments, whole.flatten())
    # A second generator loads the clustering index the first saved.
    gen2 = DynamicWorkloadGenerator(workload_dir=tmp_path, base_vectors=base, device="cpu",
                                    **dict(GEN, initial_size=500))
    gen2.initialize_clustered_index()
    np.testing.assert_array_equal(gen2.assignments, gen.assignments)


def test_workload_files_exist(workload):
    """tests/test_workload.py:45."""
    runbook = json.loads((workload / "runbook.json").read_text())
    assert (workload / "initial_indices.npy").exists()
    assert (workload / "base_vectors.npy").exists()
    assert runbook["summary"]["n_operations"] > 0
    ops = runbook["operations"]
    assert len(ops) == runbook["summary"]["n_operations"]
    for op_id, op in ops.items():
        assert (workload / "operations" / f"{op_id}.npy").exists()
        if op["type"] == "query":
            assert (workload / "operations" / f"{op_id}_gt_ids.npy").exists()


def test_uniform_sampler_no_duplicates():
    """tests/test_workload.py:80."""
    s = UniformSampler(np.random.default_rng(0))
    out = s.sample(np.arange(100, dtype=np.int64), 10)
    assert len(out) == 10 and len(np.unique(out)) == 10


def test_stratified_sampler_draws_from_clusters():
    """tests/test_workload.py:88, and the same draws as the JAX sampler."""
    from quake_tpu.workload.generator import StratifiedClusterSampler as JaxSampler

    rng = np.random.default_rng(1)
    centroids = rng.standard_normal((8, 4)).astype(np.float32)
    assignments = rng.integers(0, 8, 200)
    s = StratifiedClusterSampler(assignments, centroids, np.random.default_rng(5))
    js = JaxSampler(assignments, centroids, np.random.default_rng(5))
    pool = np.arange(200, dtype=np.int64)
    out = s.sample(pool, 50)
    assert 0 < len(out) <= 50
    assert len(np.unique(assignments[out])) < 8
    np.testing.assert_array_equal(out, js.sample(pool, 50))
    np.testing.assert_array_equal(s.sample(pool, 30), js.sample(pool, 30))


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "per_query"])
def test_evaluator_runs_and_reports_recall(workload, tmp_path, batch):
    """tests/test_workload.py:60 on the port, batched and per query, with
    maintenance after every operation; the summary's columns."""
    ev = WorkloadEvaluator(workload_dir=workload, output_dir=tmp_path / "out")
    results = ev.evaluate_workload(
        name=f"quake_{batch}", index=QuakeWrapper(device="cpu"),
        build_params={"nc": 32, "metric": "l2"}, search_params={"k": 10, "nprobe": 16},
        do_maintenance=True, m_params=MaintenancePolicyParams(window_size=50), batch=batch)
    recalls = [r["recall"] for r in results if r["operation_type"] == "query"]
    assert recalls and all(0.0 <= r <= 1.0 for r in recalls)
    assert np.mean(recalls) > 0.5
    assert all("n_list" in r and "n_total" in r for r in results)
    assert all(r["n_total"] == r["n_resident"] for r in results)
    assert all(r["maintenance_ms"] is not None and r["maintenance_splits"] is not None
               for r in results)
    assert set(ev.summary) >= {"avg_insert_latency_ms", "avg_query_recall",
                               "avg_maintenance_ms"}


def test_evaluator_non_batched_path(tmp_path):
    """tests/test_misc.py:136 on the port."""
    gen = DynamicWorkloadGenerator(
        workload_dir=tmp_path / "w", base_vectors=_base(2000, 8, seed=3), metric="l2",
        insert_ratio=0.0, delete_ratio=0.0, query_ratio=1.0, update_batch_size=10,
        query_batch_size=4, number_of_operations=3, initial_size=1000, cluster_size=100,
        cluster_sample_distribution="uniform", device="cpu")
    gen.generate_workload()
    ev = WorkloadEvaluator(workload_dir=tmp_path / "w", output_dir=tmp_path / "o")
    results = ev.evaluate_workload(name="q", index=QuakeWrapper(device="cpu"),
                                   build_params={"nc": 8, "metric": "l2"},
                                   search_params={"k": 5, "nprobe": 8}, batch=False)
    recalls = [r["recall"] for r in results if r["operation_type"] == "query"]
    assert recalls and all(r >= 0.99 for r in recalls)


def test_evaluator_from_the_jax_saved_index(workload, tmp_path):
    """The JAX evaluator builds and saves the initial index; the port's
    evaluator loads it (load, then the maintenance policy of m_params) and
    replays the same operations with maintenance: n_total equal after every
    operation, each query's recall within 0.01."""
    build, search = {"nc": 32, "metric": "l2"}, {"k": 10, "nprobe": 8}
    jax_res = JaxWorkloadEvaluator(workload_dir=workload, output_dir=tmp_path / "j"
                                   ).evaluate_workload(
        name="shared", index=JaxQuakeWrapper(), build_params=build, search_params=search,
        do_maintenance=True, m_params=JaxMaintenancePolicyParams(window_size=50))
    assert (workload / "init_indexes" / "shared.index").exists()
    ev = WorkloadEvaluator(workload_dir=workload, output_dir=tmp_path / "t")
    wrapper = QuakeWrapper(device="cpu")
    res = ev.evaluate_workload(name="shared", index=wrapper, build_params=build,
                               search_params=search, do_maintenance=True,
                               m_params=MaintenancePolicyParams(window_size=50))
    assert wrapper.index.maintenance_policy.params.window_size == 50
    assert [r["operation_type"] for r in res] == [r["operation_type"] for r in jax_res]
    assert [r["n_total"] for r in res] == [r["n_total"] for r in jax_res]
    assert [r["n_total"] for r in res] == [r["n_resident"] for r in res]
    pairs = [(a["recall"], b["recall"]) for a, b in zip(res, jax_res)
             if a["operation_type"] == "query"]
    assert pairs and all(abs(a - b) <= 0.01 for a, b in pairs), pairs
