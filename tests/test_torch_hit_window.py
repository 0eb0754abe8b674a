"""The port's hit window, one ring array (quake_tpu_torch/maintenance/
hit_tracker.py), against the JAX package's list of per-query arrays and
against the loop that aggregated that list, on the CPU.

  * seeded sequences of host records and device batches (widths that grow,
    overflow past the window, inspections at random points, invalidations
    with and without rows): the same window, scanned sizes and scan fraction
    as the JAX tracker fed the same sequence, and hit_counts equal to the
    np.add.at loop over the window;
  * an invalidation without rows leaves the ring byte for byte, and a
    maintenance() that decides nothing opens no quake.maint.invalidate span;
  * two maintenance() rounds that split and delete, in both packages: the
    second reads a window the first invalidated, and decides alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import MaintenancePolicyParams as JaxPolicyParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu.maintenance.hit_tracker import HitCountTracker as JaxTracker
from quake_tpu_torch import IndexBuildParams, MaintenancePolicyParams, QuakeIndex, SearchParams
from quake_tpu_torch.maintenance import HitCountTracker
from quake_tpu_torch.profiling import device_trace, last_spans
from test_torch_maintenance import _policy_params, _rows, aged_jax  # noqa: F401

P = 12  # partitions that hit_counts keeps; pids reach P + 2 and -1


def _loop_counts(per_query_hits, num_partitions):
    """The aggregate as perform_maintenance computed it before the ring."""
    agg = np.zeros(num_partitions, dtype=np.int64)
    for hits in per_query_hits:
        np.add.at(agg, hits[(hits >= 0) & (hits < num_partitions)], 1)
    return agg


def _ring(t):
    return (t._hits.tobytes(), t._live.tobytes(), t._sizes.tobytes(), t._head, t._count,
            t.invalidated_hits)


def _check(tj, tt, sizes):
    want, got = tj.get_per_query_hits(sizes), tt.get_per_query_hits(sizes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert tt._scanned_sizes == tj._scanned_sizes
    assert tt.get_current_scan_fraction() == tj.get_current_scan_fraction()
    assert tt.get_num_queries_recorded() == tj.get_num_queries_recorded()
    for n in (P, P + 3, 1):
        np.testing.assert_array_equal(tt.hit_counts(n), _loop_counts(got, n))


@pytest.mark.parametrize("seed", range(8))
def test_ring_matches_jax_and_loop(seed):
    rng = np.random.default_rng(seed)
    window = int(rng.integers(5, 24))
    tj, tt = JaxTracker(window, 1000), HitCountTracker(window, 1000)
    sizes = rng.integers(0, 50, P + 3)
    width, invalidated = 1, 0
    for _ in range(60):
        op = rng.random()
        if op < 0.3:  # a host record, a list that may be wider than any before
            width += int(rng.random() < 0.2)
            pids = rng.integers(-1, P + 3, int(rng.integers(0, width + 1)))
            scanned = int(rng.integers(0, 500))
            tj.add_query_data(pids, scanned)
            tt.add_query_data(pids, scanned)
        elif op < 0.65:  # a device batch, at times past the window alone
            width += int(rng.random() < 0.3)
            b = int(rng.integers(0, window + 4))
            pids = rng.integers(-1, P + 3, (b, width)).astype(np.int32)
            scanned = rng.integers(0, width + 2, b).astype(np.int32)
            tj.add_batch_device(jnp.asarray(pids), jnp.asarray(scanned))
            tt.add_batch_device(torch.from_numpy(pids), torch.from_numpy(scanned))
        elif op < 0.8:
            _check(tj, tt, sizes)
        elif op < 0.9:  # no rows: nothing to do
            before = _ring(tt)
            tj.invalidate_rows([])
            tt.invalidate_rows([])
            assert _ring(tt) == before
        else:
            rows = rng.choice(P + 3, int(rng.integers(1, 4)), replace=False).tolist()
            n_before = sum(len(h) for h in tj._queries)
            tj.invalidate_rows(rows)
            tt.invalidate_rows(rows)
            invalidated += n_before - sum(len(h) for h in tj._queries)
            assert tt.invalidated_hits == invalidated
    _check(tj, tt, sizes)
    tt.reset()
    assert tt.get_per_query_hits() == [] and tt.get_current_scan_fraction() == 1.0
    assert not tt.hit_counts(P).any()


def test_hit_counts_without_sizes():
    """hit_counts materializes the pending batches as get_per_query_hits
    does: scanned sizes 0 without partition sizes."""
    t = HitCountTracker(window_size=4, total_vectors=10)
    t.add_batch_device(torch.tensor([[2, -1, 2, 5]], dtype=torch.int32),
                       torch.tensor([3], dtype=torch.int32))
    np.testing.assert_array_equal(t.hit_counts(4), [0, 0, 2, 0])
    assert t._scanned_sizes == [0] and not t._pending
    np.testing.assert_array_equal(t.get_per_query_hits()[0], [2, 2, 5])


def test_idle_maintenance_leaves_window(tmp_path):
    """maintenance() that splits and deletes nothing: no quake.maint.
    invalidate span, and the materialized window left byte for byte."""
    x = np.random.default_rng(3).standard_normal((2000, 16)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, np.arange(2000), IndexBuildParams(nlist=8, calibrate_aps=False))
    idx.initialize_maintenance_policy(MaintenancePolicyParams(
        window_size=16, split_threshold_ns=1e30, delete_threshold_ns=1e30))
    idx.search(x[:32], SearchParams(k=5, nprobe=3))
    tracker = idx.maintenance_policy.hit_count_tracker
    tracker.get_per_query_hits(idx.store.partition_sizes())
    before = _ring(tracker)
    with device_trace(str(tmp_path)):
        mt = idx.maintenance()
    table = last_spans()
    assert (mt.n_splits, mt.n_deletes) == (0, 0)
    assert table["quake.maint.window"]["calls"] == 1
    assert "quake.maint.invalidate" not in table
    assert _ring(tracker) == before and tracker.invalidated_hits == 0


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_second_round_matches_jax(aged_jax, monkeypatch, host):  # noqa: F811
    """Round one splits the hot rows and deletes the aged ones, and
    invalidates their hits; round two reads that window with new hits on
    other rows, and both packages decide alike again."""
    if host:
        monkeypatch.setenv("QUAKE_TPU_MAINT_HOST", "1")
    path, hot = aged_jax
    j, t = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    j.initialize_maintenance_policy(_policy_params(JaxPolicyParams))
    t.initialize_maintenance_policy(_policy_params(MaintenancePolicyParams))
    for _ in range(60):
        j.maintenance_policy.record_query_hits(hot)
        t.maintenance_policy.record_query_hits(hot)
    wi, ti = j.maintenance(), t.maintenance()
    assert (ti.n_splits, ti.n_deletes) == (wi.n_splits, wi.n_deletes)
    assert ti.n_splits > 0 and ti.n_deletes > 0
    tt = t.maintenance_policy.hit_count_tracker
    assert tt.invalidated_hits > 0
    # Five entries of new hits on the last three active rows: round two
    # reads 45 entries emptied by the invalidation and these five.
    rows = [int(r) for r in t.store.active_rows()[-3:]]
    for _ in range(5):
        j.maintenance_policy.record_query_hits(rows)
        t.maintenance_policy.record_query_hits(rows)
    sizes = t.store.partition_sizes()
    tj = j.maintenance_policy.hit_count_tracker
    for g, w in zip(tt.get_per_query_hits(sizes), tj.get_per_query_hits(sizes), strict=True):
        np.testing.assert_array_equal(g, w)
    wi, ti = j.maintenance(), t.maintenance()
    assert (ti.n_splits, ti.n_deletes) == (wi.n_splits, wi.n_deletes)
    assert ti.n_splits > 0
    assert (t.nlist(), t.ntotal()) == (j.nlist(), j.ntotal())
    assert _rows(t) == _rows(j)
    np.testing.assert_array_equal(t.store.active_rows(), j.store.active_rows())
