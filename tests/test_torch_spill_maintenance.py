"""Maintenance of a SOAR-spilled index in the port against the JAX package,
on the CPU: `maintenance()`'s decisions on a hand-recorded window, its
splits (the host path: each copy keeps its map), its deletes (each orphan
copy re-homed away from its twin's partition) and local refinement (twins
pooled into one cluster separated), mirroring tests/test_spill.py:112-280.

Each case builds one JAX index, carries it across (test_torch_spill.py's
`carry`), runs the same calls through both and holds the two stores and
both id maps equal (the host clustering is the same numpy code in both
packages), with every id resident exactly twice in two different
partitions; full-probe search finds every neighbour, none twice.
"""

import numpy as np
import pytest

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import MaintenancePolicyParams as JaxPolicyParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu_torch import MaintenancePolicyParams, SearchParams
from quake_tpu_torch.maintenance.policy import separate_twins
from quake_tpu_torch.utils import compute_recall, knn
from test_torch_spill import _kernel, assert_same_index, carry
from test_torch_spill_ops import assert_no_dups


def _built(n, d, nlist, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    jidx = JaxIndex()
    jidx.build(x, np.arange(n), JaxBuildParams(nlist=nlist, spill=True))
    tidx = carry(jidx)
    assert_same_index(jidx, tidx)
    return jidx, tidx, x


def _policies(jidx, tidx, **kw):
    jidx.initialize_maintenance_policy(JaxPolicyParams(**kw))
    tidx.initialize_maintenance_policy(MaintenancePolicyParams(**kw))


def _full_probe_exact(tidx, x, seed):
    q = np.random.default_rng(seed).standard_normal((16, x.shape[1])).astype(np.float32)
    gt, _ = knn(q, x, 10, "l2")
    with _kernel("xla"):
        res = tidx.search(q, SearchParams(k=10, nprobe=tidx.nlist()))
    assert_no_dups(res.ids)
    assert compute_recall(res.ids, gt, 10) >= 0.999


def test_maintenance_split_matches_jax():
    """Skewed hits on two partitions split them (tests/test_spill.py:
    112-146 at 8000 vectors): the same decisions, the same halves and the
    same refinement of their neighbourhood in both packages."""
    jidx, tidx, x = _built(8000, 16, 4, seed=18)
    _policies(jidx, tidx, window_size=50, split_threshold_ns=0.0, delete_threshold_ns=1e9)
    rows = tidx.store.active_rows()[:2].tolist()
    for _ in range(60):
        jidx.maintenance_policy.record_query_hits(rows)
        tidx.maintenance_policy.record_query_hits(rows)
    ij, it = jidx.maintenance(), tidx.maintenance()
    assert it.n_splits == ij.n_splits > 0 and it.n_deletes == ij.n_deletes == 0
    assert tidx.nlist() > 4
    assert_same_index(jidx, tidx)
    _full_probe_exact(tidx, x, 1)


def test_maintenance_delete_rehomes_matches_jax():
    """Cold partitions deleted without rejection (tests/test_spill.py:
    237-261 at 6000 vectors): each orphan copy keeps its map and goes to
    its best parent candidate that is not its twin's partition."""
    jidx, tidx, x = _built(6000, 16, 12, seed=20)
    _policies(jidx, tidx, window_size=50, delete_threshold_ns=0.0, split_threshold_ns=1e9,
              enable_delete_rejection=False)
    hot = tidx.store.active_rows()[:2].tolist()
    for _ in range(60):
        jidx.maintenance_policy.record_query_hits(hot)
        tidx.maintenance_policy.record_query_hits(hot)
    ij, it = jidx.maintenance(), tidx.maintenance()
    assert it.n_deletes == ij.n_deletes > 0 and tidx.nlist() < 12
    assert tidx.ntotal() == 6000
    assert_same_index(jidx, tidx)
    _full_probe_exact(tidx, x, 2)


def test_delete_both_twins_rows_matches_jax():
    """Both partitions of many ids deleted at once: their two copies go to
    the first and the second parent candidate, staying apart."""
    jidx, tidx, _ = _built(6000, 16, 12, seed=22)
    rows = tidx.store.active_rows()[[1, 4, 7]].tolist()
    jidx.maintenance_policy._delete_partitions(rows)
    tidx.maintenance_policy._delete_partitions(rows)
    assert_same_index(jidx, tidx)


@pytest.mark.parametrize("iterations", [1, 2])
def test_refinement_separates_twins_matches_jax(iterations):
    """Refinement of every partition (tests/test_spill.py:264-280 at 6000
    vectors): Lloyd pools both copies of an id into one cluster, the later
    one moves to its nearest other centroid, each copy keeps its map."""
    jidx, tidx, x = _built(6000, 16, 12, seed=21)
    rows = tidx.store.active_rows().tolist()
    jidx.maintenance_policy.refine_partitions(rows, iterations=iterations)
    tidx.maintenance_policy.refine_partitions(rows, iterations=iterations)
    assert_same_index(jidx, tidx)
    _full_probe_exact(tidx, x, 3)


def test_separate_twins_order():
    """A cluster keeps its first occurrences in order, then takes the later
    copies moved into it: cluster by cluster, within one from the last
    moved to the first (the JAX package's copy-by-copy loop)."""
    v = np.eye(3, dtype=np.float32)
    cents = np.stack([v[0], v[1] + v[2], v[2] + 0.1])
    clusters = [(np.stack([v[1], v[2], v[1], v[2]]), np.array([7, 8, 7, 8])),
                (np.stack([v[0], v[0]]), np.array([9, 9])),
                (np.zeros((0, 3), np.float32), np.zeros(0, np.int64))]
    out = separate_twins(clusters, cents)
    # The later 8 (v2) goes to cluster 2, the later 7 (v1) to cluster 1
    # (nearest other than 0); the later 9 (v0) back to cluster 0.
    assert [c[1].tolist() for c in out] == [[7, 8, 9], [9, 7], [8]]
    np.testing.assert_array_equal(out[0][0], np.stack([v[1], v[2], v[0]]))
    np.testing.assert_array_equal(out[1][0], np.stack([v[0], v[1]]))
    clusters[0] = (np.stack([v[1], v[1] * 2, v[1], v[1] * 2]), np.array([7, 8, 7, 8]))
    out = separate_twins(clusters, cents)
    assert out[1][1].tolist() == [9, 8, 7]  # the last moved first
