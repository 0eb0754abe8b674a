"""tests/test_stress.py against the port, on the CPU (device="cpu"): the
stress tests mirroring reference test/cpp/quake_index.cpp: repeated
build-search (:322), rapid add/remove (:400), high-dim (:448), mixed
search+add+remove+maintenance (:482), empty and tiny indices, and
concurrent searches. The card's concurrent search is
tests/test_torch_cuda.py::test_concurrent_searches_cuda."""

import numpy as np
import pytest

from quake_tpu_torch import IndexBuildParams, MaintenancePolicyParams, QuakeIndex, SearchParams
from quake_tpu_torch.utils import compute_recall, knn


def _index():
    return QuakeIndex(device="cpu")


def test_repeated_build_search():
    rng = np.random.default_rng(0)
    for trial in range(3):
        x = rng.standard_normal((2000, 16)).astype(np.float32)
        ids = np.arange(2000, dtype=np.int64)
        idx = _index()
        idx.build(x, ids, IndexBuildParams(nlist=8))
        res = idx.search(x[:20], SearchParams(k=1, nprobe=8))
        np.testing.assert_array_equal(res.ids[:, 0], ids[:20])


def test_rapid_add_remove_cycles():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64)
    idx = _index()
    idx.build(x[:3000], ids[:3000], IndexBuildParams(nlist=16))
    extra_x, extra_ids = x[3000:], ids[3000:]
    for cycle in range(5):
        idx.add(extra_x, extra_ids)
        assert idx.ntotal() == 5000
        idx.remove(extra_ids)
        assert idx.ntotal() == 3000
    assert idx.validate()
    res = idx.search(x[:30], SearchParams(k=10, nprobe=16))
    gt, _ = knn(x[:30], x[:3000], 10)
    assert compute_recall(res.ids, gt, 10) >= 0.99


def test_high_dimensional():
    """960-d (GIST-like) build/search (quake_index.cpp:448)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3000, 960)).astype(np.float32)
    ids = np.arange(3000, dtype=np.int64)
    idx = _index()
    idx.build(x, ids, IndexBuildParams(nlist=8))
    res = idx.search(x[:10], SearchParams(k=1, nprobe=8))
    np.testing.assert_array_equal(res.ids[:, 0], ids[:10])


def test_mixed_operations_with_maintenance():
    """Interleaved search/add/remove/maintenance (quake_index.cpp:482)."""
    rng = np.random.default_rng(3)
    n, d = 8000, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    idx = _index()
    idx.build(x[:4000], ids[:4000], IndexBuildParams(nlist=16))
    idx.initialize_maintenance_policy(
        MaintenancePolicyParams(window_size=30, split_threshold_ns=0.0,
                                refinement_radius=4)
    )
    resident = set(range(4000))
    next_add = 4000
    for step in range(6):
        q = rng.standard_normal((20, d)).astype(np.float32)
        idx.search(q, SearchParams(k=5, nprobe=8))
        if next_add < n:
            batch = ids[next_add : next_add + 500]
            idx.add(x[next_add : next_add + 500], batch)
            resident |= set(batch.tolist())
            next_add += 500
        rm = sorted(resident)[: 200]
        idx.remove(np.array(rm, dtype=np.int64))
        resident -= set(rm)
        idx.maintenance()
        assert idx.ntotal() == len(resident)
    assert idx.validate()
    # Final correctness: full probe equals brute force over residents.
    rid = np.array(sorted(resident), dtype=np.int64)
    q = rng.standard_normal((20, d)).astype(np.float32)
    res = idx.search(q, SearchParams(k=10, nprobe=idx.nlist()))
    gt, _ = knn(q, x[rid], 10, ids=rid)
    assert compute_recall(res.ids, gt, 10) >= 0.99


def test_empty_and_tiny_indices():
    """Edge sizes (query_coordinator.cpp empty-partition handling)."""
    x = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    ids = np.arange(3, dtype=np.int64)
    idx = _index()
    idx.build(x, ids, IndexBuildParams(nlist=0))
    res = idx.search(x, SearchParams(k=5))
    assert (res.ids[:, 0] == ids).all()
    assert (res.ids[:, 3:] == -1).all()
    # Remove everything; search still returns padded results.
    idx.remove(ids)
    assert idx.ntotal() == 0
    res = idx.search(x[:1], SearchParams(k=3))
    assert (res.ids == -1).all()
    assert np.isinf(res.distances).all()


def test_concurrent_searches():
    """Concurrent reads are safe (mirror of ConcurrentFindIdTest /
    concurrent-read coverage, test/cpp/index_partition.cpp:605,
    dynamic_inverted_list.cpp:481): searches from multiple threads return
    the same results as serial execution."""
    import threading

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    ids = np.arange(3000, dtype=np.int64)
    idx = _index()
    idx.build(x, ids, IndexBuildParams(nlist=8))
    q = rng.standard_normal((40, 16)).astype(np.float32)
    expected = idx.search(q, SearchParams(k=5, nprobe=8)).ids

    results = [None] * 8
    def worker(i):
        results[i] = idx.search(q, SearchParams(k=5, nprobe=8)).ids

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in results:
        np.testing.assert_array_equal(r, expected)


def test_concurrent_launch_counts_and_hit_window():
    """The state every searching thread writes: the kernels' launch counts
    (_ext.launched) and the maintenance hit window lose no update under 16
    threads with a short switch interval."""
    import sys
    import threading

    from quake_tpu_torch import _ext

    rng = np.random.default_rng(6)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    idx = _index()
    idx.build(x, np.arange(3000, dtype=np.int64), IndexBuildParams(nlist=8))
    idx.initialize_maintenance_policy(MaintenancePolicyParams(window_size=100_000))
    q = rng.standard_normal((16, 16)).astype(np.float32)
    counted = dict(_ext.launches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(5):
                idx.search(q, SearchParams(k=5, nprobe=4))
            for _ in range(2000):
                _ext.launched("chunk_merge")

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _ext.launches["chunk_merge"] - counted["chunk_merge"] == 16 * 2000
    _ext.launches["chunk_merge"] = counted["chunk_merge"]
    tracker = idx.maintenance_policy.hit_count_tracker
    assert tracker.get_num_queries_recorded() == 16 * 5 * 16
    hits = tracker.get_per_query_hits(idx.store.partition_sizes())
    assert len(hits) == 16 * 5 * 16 and all(len(h) == 4 for h in hits)
