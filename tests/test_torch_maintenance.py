"""Cost-based maintenance in the port against the JAX package, on the CPU.

What is held, and how closely:
  * the hit tracker, the latency model and the cost model on the same
    inputs as the JAX package's (tests/test_maintenance.py's cases): the
    same windows, the same grid values and deltas (equal: the same Python
    float arithmetic), the CSV profile byte for byte in both directions;
  * the profiled grid on the CPU ("xla", as the JAX package profiles off a
    TPU) and its round trip through save and load; the packaged H100 grid
    (its provenance and d-scaling; tests/test_torch_latency_packaged.py holds
    its law to the JAX package's);
  * decision parity: a JAX index saved and loaded into both packages (the
    same slots and free rows), the same host-recorded window, then
    maintenance(): the same splits and deletes, the same id set in every
    row, centroids of both levels within 1e-5, ROADMAP Queue 3 contract 6
    at both levels, on the batched device path and on the host path
    (QUAKE_TPU_MAINT_HOST=1);
  * the window every search path records (fused, query-major, unfused
    batched, APS oneshot, planned and loop, the dense route) equal to the
    JAX package's for the same queries;
  * fault 5: every IVF build and load sets a policy in both packages;
  * tests/test_maintenance.py's end-to-end cases on the port alone.
"""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import MaintenancePolicyParams as JaxPolicyParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.maintenance.cost_estimator import MaintenanceCostEstimator as JaxCost
from quake_tpu.maintenance.hit_tracker import HitCountTracker as JaxTracker
from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator as JaxLatency
from quake_tpu_torch import (IndexBuildParams, MaintenancePolicyParams, QuakeIndex,
                             SearchParams)
from quake_tpu_torch.maintenance import (HitCountTracker, ListScanLatencyEstimator,
                                         MaintenanceCostEstimator)
from quake_tpu_torch.profiling import device_trace, last_spans
from quake_tpu_torch.utils import compute_recall, knn
from test_torch_store_mutation import _contract_6

TRACKERS = ((JaxTracker, jnp.asarray), (HitCountTracker, torch.from_numpy))


def _both(run):
    """run(tracker_class, array_fn) for the JAX tracker and the port's;
    both results must agree."""
    (jt, ja), (tt, ta) = TRACKERS
    want, got = run(jt, ja), run(tt, ta)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    return got


@pytest.mark.parametrize("name", ["MaintenancePolicyParams", "MaintenanceTimingInfo"])
def test_params_and_timing_match_jax(name):
    """The port's maintenance parameters and timing carry every field of the
    JAX package's, with the same defaults, and are exported alike."""
    import dataclasses

    import quake_tpu
    import quake_tpu_torch

    ours, theirs = getattr(quake_tpu_torch, name), getattr(quake_tpu, name)
    assert name in quake_tpu_torch.__all__
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


# --------------------------------------------------------------- hit tracker


def test_hit_tracker_window_cycling():
    def run(cls, arr):
        t = cls(window_size=5, total_vectors=100)
        for i in range(8):
            t.add_query_data(np.array([i % 3]), scanned_size=10)
        assert t.get_num_queries_recorded() == 5
        return t.get_per_query_hits()

    assert len(_both(run)) == 5


def test_hit_tracker_scan_fraction():
    for cls, _ in TRACKERS:
        t = cls(window_size=4, total_vectors=100)
        for _ in range(4):
            t.add_query_data(np.array([0]), scanned_size=25)
        assert abs(t.get_current_scan_fraction() - 0.25) < 1e-6


def test_hit_tracker_device_batches():
    def run(cls, arr):
        t = cls(window_size=10, total_vectors=100)
        t.add_batch_device(arr(np.tile(np.arange(4, dtype=np.int32), (6, 1))),
                           arr(np.full(6, 2, np.int32)))
        assert t.get_num_queries_recorded() == 6
        hits = t.get_per_query_hits(np.full(4, 10))
        assert hits[0].tolist() == [0, 1]  # only the first `scanned` ranks
        return hits + [np.asarray(t._scanned_sizes)]

    assert len(_both(run)) == 7


def test_hit_tracker_device_overflow_keeps_circular_window():
    """Batches past the window behave as a circular window: exactly the
    newest window_size entries survive, in order."""
    def run(cls, arr):
        t = cls(window_size=10, total_vectors=100)
        for b in range(5):
            t.add_batch_device(arr(np.full((4, 2), b, np.int32)), arr(np.ones(4, np.int32)))
        assert t.get_num_queries_recorded() <= 12
        return t.get_per_query_hits(np.full(8, 10))

    hits = _both(run)
    assert [int(h[0]) for h in hits] == [2, 2, 3, 3, 3, 3, 4, 4, 4, 4]


def test_hit_tracker_interleaved_host_device_keeps_host_entries():
    def run(cls, arr):
        t = cls(window_size=10, total_vectors=100)
        for _ in range(4):
            t.add_query_data(np.array([7]), scanned_size=10)
        for _ in range(3):
            t.add_batch_device(arr(np.zeros((3, 1), np.int32)), arr(np.ones(3, np.int32)))
        return t.get_per_query_hits(np.full(8, 10))

    assert [int(h[0]) for h in _both(run)] == [7] + [0] * 9


def test_tracker_keeps_references():
    """The port records the search's tensors by reference (no copy on the
    search path) and reads each pending batch once, at inspection."""
    t = HitCountTracker(window_size=8, total_vectors=10)
    pids, scanned = torch.zeros((4, 2), dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    t.add_batch_device(pids, scanned)
    assert t._pending[0][0] is pids and t._pending[0][1] is scanned
    assert len(t.get_per_query_hits()) == 4 and not t._pending


# --------------------------------------------------------- latency estimator


@pytest.mark.parametrize("d", [16, 32, 64, 960])
def test_analytic_grid_equals_jax(d):
    """The analytic model's constants are the JAX package's: the same grid."""
    np.testing.assert_array_equal(ListScanLatencyEstimator(d).latency_grid,
                                  JaxLatency(d, packaged=False).latency_grid)
    assert ListScanLatencyEstimator(d).grid_source == "analytic"


def test_latency_estimator_monotone_in_n():
    est, ref = ListScanLatencyEstimator(d=64), JaxLatency(d=64, packaged=False)
    l1, l2 = est.estimate_scan_latency(100, 10), est.estimate_scan_latency(10_000, 10)
    assert l2 > l1 > 0
    assert (l1, l2) == (ref.estimate_scan_latency(100, 10), ref.estimate_scan_latency(10_000, 10))


def test_latency_estimator_interpolation_between_grid_points():
    est, ref = ListScanLatencyEstimator(d=32), JaxLatency(d=32, packaged=False)
    lo, mid, hi = (est.estimate_scan_latency(n, 16) for n in (1024, 2048, 4096))
    assert lo <= mid <= hi
    assert mid == ref.estimate_scan_latency(2048, 16)


def test_latency_estimator_extrapolation_beyond_grid():
    est, ref = ListScanLatencyEstimator(d=32), JaxLatency(d=32, packaged=False)
    inside = est.estimate_scan_latency(65536, 256)
    outside = est.estimate_scan_latency(200_000, 256)
    assert outside > inside
    assert outside == ref.estimate_scan_latency(200_000, 256)


def test_latency_estimator_csv_roundtrip(tmp_path):
    """The CSV is the JAX package's, byte for byte, and each package loads
    the other's."""
    est = ListScanLatencyEstimator(d=16)
    est.latency_grid *= 2.0
    ref = JaxLatency(d=16, packaged=False)
    ref.latency_grid *= 2.0
    p, q = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    est.save(p)
    ref.save(q)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    back = ListScanLatencyEstimator(d=16)
    assert back.load(q) and back.grid_source == "csv"
    np.testing.assert_allclose(back.latency_grid, est.latency_grid, rtol=1e-5)
    assert JaxLatency(d=16, packaged=False).load(p)


def test_latency_estimator_grid_mismatch_rejected(tmp_path):
    p = str(tmp_path / "profile.csv")
    JaxLatency(d=16, packaged=False).save(p)
    with pytest.raises(ValueError, match="grid mismatch"):
        ListScanLatencyEstimator(d=32).load(p)
    with pytest.raises(ValueError, match="grid mismatch"):
        ListScanLatencyEstimator(d=16, n_values=[1, 2]).load(p)


def test_packaged_grid_refused():
    """The refusal is lifted: the port packages grids measured on the H100
    (tests/test_torch_latency_packaged.py holds them to the JAX package's
    law). tests/test_maintenance.py::test_packaged_grid_provenance_and_
    d_scaling on the port: the default off the card is analytic, the forced
    packaged grid names its d and scale, a d between the grids is each
    point affine in d through the two committed grids (rtol 1e-6), and an
    explicit profile overrides it."""
    assert ListScanLatencyEstimator(d=960).grid_source == "analytic"
    assert ListScanLatencyEstimator(d=128, packaged=None).grid_source == "analytic"
    est128 = ListScanLatencyEstimator(d=128, packaged=True)
    assert est128.grid_source == "packaged(d=128,scale=1.000)"
    from quake_tpu_torch.maintenance.latency_estimator import monotone

    est768 = ListScanLatencyEstimator(d=768, packaged=True)
    est960 = ListScanLatencyEstimator(d=960, packaged=True)
    assert est960.grid_source == "packaged(d=128..768,at=960)"
    want = est768.latency_grid + (960 - 768) / (128 - 768) * (est128.latency_grid
                                                             - est768.latency_grid)
    np.testing.assert_allclose(est960.latency_grid, monotone(want), rtol=1e-6)
    est = ListScanLatencyEstimator(d=16, n_values=[64, 512], k_values=[1, 8], n_trials=2,
                                   packaged=True)
    est.profile_grouped_latency(kernel="xla", n_queries=64, device="cpu")
    assert est.grid_source == "profiled"


def test_profile_grouped_latency_and_roundtrip(tmp_path):
    """The grouped scan profiled over a small grid on the CPU ("xla"), saved
    and loaded, in the port and by the JAX package."""
    est = ListScanLatencyEstimator(d=16, n_values=[64, 512], k_values=[1, 8], n_trials=2)
    est.profile_grouped_latency(kernel="xla", n_queries=64, device="cpu")
    assert (est.latency_grid > 0).all() and est.grid_source == "profiled"
    p = str(tmp_path / "prof.csv")
    est.save(p)
    for cls in (ListScanLatencyEstimator, JaxLatency):
        back = cls.from_csv(p)
        np.testing.assert_allclose(back.latency_grid, est.latency_grid, rtol=1e-5)
        assert back.n_values == [64, 512] and back.k_values == [1, 8]


# ------------------------------------------------------------ cost estimator


def _cost_pair(**kw):
    return MaintenanceCostEstimator(**kw), JaxCost(**kw)


def test_split_delta_sign_behavior():
    est, ref = _cost_pair(d=64, alpha=0.9, k=10)
    hot_large = est.compute_split_delta(65536, hit_rate=1.0, total_partitions=100)
    cold = est.compute_split_delta(65536, hit_rate=0.0, total_partitions=100)
    assert hot_large < cold
    assert cold > 0 or abs(cold) < 1e3
    assert (hot_large, cold) == (ref.compute_split_delta(65536, 1.0, 100),
                                 ref.compute_split_delta(65536, 0.0, 100))


def test_delete_delta_sign_behavior():
    est, ref = _cost_pair(d=64, alpha=0.9, k=10)
    args = dict(total_partitions=100, avg_partition_hit_rate=0.5, avg_partition_size=1000)
    cold = est.compute_delete_delta(1000, hit_rate=0.0, **args)
    hot = est.compute_delete_delta(1000, hit_rate=1.0, **args)
    assert cold < hot
    assert est.compute_delete_delta(1000, 0.0, 1, 0.5, 1000) == 0.0
    assert (cold, hot) == (ref.compute_delete_delta(1000, hit_rate=0.0, **args),
                           ref.compute_delete_delta(1000, hit_rate=1.0, **args))
    for size in (5, 100, 5000):  # both branches of the merged cost
        assert (est.compute_delete_delta_w_reassign(size, 0.1, 50, [3, 2], [40, 900],
                                                    [0.0, 0.4])
                == ref.compute_delete_delta_w_reassign(size, 0.1, 50, [3, 2], [40, 900],
                                                       [0.0, 0.4]))


def test_invalid_estimator_params_rejected():
    with pytest.raises(ValueError):
        MaintenanceCostEstimator(d=8, alpha=0.0, k=10)
    with pytest.raises(ValueError):
        MaintenanceCostEstimator(d=8, alpha=0.9, k=0)


def test_profiled_grid_changes_maintenance_decisions():
    """A grid where large partitions cost disproportionately makes splits
    pay; a flat one does not."""
    flat = ListScanLatencyEstimator(d=16)
    flat.latency_grid = np.full_like(flat.latency_grid, 1000.0)
    steep = ListScanLatencyEstimator(d=16)
    steep.latency_grid = np.array([[n * 100.0 + k for k in steep.k_values]
                                   for n in steep.n_values])
    d_flat = MaintenanceCostEstimator(16, alpha=0.9, k=10, latency_estimator=flat) \
        .compute_split_delta(4096, hit_rate=1.0, total_partitions=64)
    d_steep = MaintenanceCostEstimator(16, alpha=0.9, k=10, latency_estimator=steep) \
        .compute_split_delta(4096, hit_rate=1.0, total_partitions=64)
    assert d_flat > 0 > d_steep


# --------------------------------------------------------------- the index


def test_build_flag_profiles_and_persists(tmp_path, small_data):
    """profile_latency() wires the grid into the live policy; save and load
    restore it in the port and in the JAX package, each with a fresh policy
    wired to the loaded grid."""
    x, ids, _ = small_data
    idx = QuakeIndex(device="cpu")
    idx.build(x[:3000], ids[:3000], IndexBuildParams(nlist=8))
    est = idx.profile_latency(n_values=[64, 256], k_values=[1, 8])
    assert idx.maintenance_policy.cost_estimator.latency_estimator is est
    d = str(tmp_path / "idx")
    idx.save(d)
    for back in (QuakeIndex(device="cpu").load(d), JaxIndex().load(d)):
        assert back.latency_profile is not None and back.latency_profile.grid_source == "csv"
        np.testing.assert_allclose(back.latency_profile.latency_grid, est.latency_grid,
                                   rtol=1e-5)
        assert back.maintenance_policy.cost_estimator.latency_estimator is back.latency_profile


def test_fault_5_policy_after_build_and_load(tmp_path):
    """Every IVF build and load sets a maintenance policy, in both packages;
    a flat index has none."""
    x = np.random.default_rng(4).standard_normal((1500, 8)).astype(np.float32)
    for nlist, has in ((6, True), (0, False)):
        j, t = JaxIndex(), QuakeIndex(device="cpu")
        j.build(x, np.arange(1500), JaxBuildParams(nlist=nlist, calibrate_aps=False))
        t.build(x, None, IndexBuildParams(nlist=nlist, calibrate_aps=False))
        path = str(tmp_path / f"n{nlist}")
        j.save(path)
        for idx in (j, t, JaxIndex().load(path), QuakeIndex(device="cpu").load(path)):
            assert (idx.maintenance_policy is not None) == has
            if has:
                assert idx.maintenance_policy.hit_count_tracker.get_num_queries_recorded() == 0
                assert idx.maintenance_policy.cost_estimator.latency_estimator.grid_source == \
                    "analytic"


def _skewed(n=8_000, d=16, nlist=32, window=100, delete_threshold=10.0,
            split_threshold=10.0):
    """tests/test_maintenance.py::build_skewed_index in the port: the
    reference's own trigger tests set the thresholds near 0
    (test/cpp/maintenance.cpp:112-127)."""
    x = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, np.arange(n), IndexBuildParams(nlist=nlist, calibrate_aps=False))
    idx.initialize_maintenance_policy(MaintenancePolicyParams(
        window_size=window, refinement_radius=8, delete_threshold_ns=delete_threshold,
        split_threshold_ns=split_threshold))
    return idx, x


def test_maintenance_noop_without_full_window():
    idx, _ = _skewed()
    nlist = idx.nlist()
    info = idx.maintenance()
    assert info.n_splits == 0 and info.n_deletes == 0 and idx.nlist() == nlist


def test_maintenance_splits_hot_partitions():
    idx, _ = _skewed(n=30_000, nlist=4, window=50, split_threshold=0.0, delete_threshold=1e9)
    for _ in range(60):
        idx.maintenance_policy.record_query_hits([0, 1])
    nlist, ntotal = idx.nlist(), idx.ntotal()
    info = idx.maintenance()
    assert info.n_splits > 0
    assert idx.nlist() > nlist - info.n_deletes
    assert idx.ntotal() == ntotal and idx.validate()
    assert idx.parent.ntotal() == idx.nlist()


def test_maintenance_deletes_cold_partitions():
    idx, _ = _skewed(n=10_000, d=4, nlist=100, window=50, delete_threshold=0.0,
                     split_threshold=1e9)
    for _ in range(60):
        idx.maintenance_policy.record_query_hits([0])
    ntotal = idx.ntotal()
    info = idx.maintenance()
    assert info.n_deletes > 0
    assert idx.ntotal() == ntotal and idx.validate()
    assert idx.parent.ntotal() == idx.nlist()


def test_search_feeds_hit_window():
    idx, x = _skewed(window=20)
    idx.search(x[:10], SearchParams(k=5, nprobe=4))
    idx.search(x[:10], SearchParams(k=5, nprobe=4))
    assert idx.maintenance_policy.hit_count_tracker.get_num_queries_recorded() >= 20


def test_search_correct_after_maintenance(monkeypatch):
    """Full-probe recall after splits and refinement, on the exact "xla"
    scan the JAX package runs on the CPU (the port's CPU default, v11,
    quantizes its keys: 0.974 here before maintenance as after)."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    idx, x = _skewed(n=30_000, nlist=4, window=50, split_threshold=0.0)
    for _ in range(60):
        idx.maintenance_policy.record_query_hits([0, 1])
    idx.maintenance()
    q = x[:50]
    res = idx.search(q, SearchParams(k=10, nprobe=idx.nlist()))
    gt, _ = knn(q, x, 10, "l2")
    assert compute_recall(res.ids, gt, 10) >= 0.99


def test_maintenance_flushes_pending_adds():
    """maintenance() inserts the buffered adds before it reads the store."""
    x = np.random.default_rng(8).standard_normal((3000, 8)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x[:2000], None, IndexBuildParams(nlist=8, calibrate_aps=False,
                                               mutation_buffer_size=4096))
    idx.add(x[2000:], np.arange(2000, 3000))
    assert idx._pending_vids
    idx.maintenance()
    assert not idx._pending_vids and idx.store.ntotal() == 3000


# --------------------------------------------------------- decision parity

N_PAR, D_PAR, NLIST_PAR = 24_000, 8, 16


@pytest.fixture(scope="module")
def aged_jax(tmp_path_factory):
    """A JAX index whose three smallest partitions aged out (3 vectors left
    in each), saved with a steep latency profile (L = 100 n + k ns, the
    shape of test_profiled_grid_changes_maintenance_decisions), under which
    one window both deletes and splits; the hot rows are the two whose
    sizes are nearest the mean."""
    x = np.random.default_rng(21).standard_normal((N_PAR, D_PAR)).astype(np.float32)
    j = JaxIndex()
    j.build(x, np.arange(N_PAR), JaxBuildParams(nlist=NLIST_PAR, calibrate_aps=False))
    sizes = j.store.partition_sizes()
    active = j.store.active_rows()
    order = active[np.argsort(sizes[active], kind="stable")]
    for r in order[:3]:
        _, vids = j.store.get_partition(int(r))
        j.remove(vids[3:])
    rest = order[3:]
    near = rest[np.argsort(np.abs(sizes[rest] - sizes[rest].mean()), kind="stable")]
    grid = JaxLatency(D_PAR, packaged=False)
    grid.latency_grid = np.array([[n * 100.0 + k for k in grid.k_values]
                                  for n in grid.n_values])
    j.latency_profile = grid
    path = str(tmp_path_factory.mktemp("aged") / "idx")
    j.save(path)
    return path, [int(r) for r in near[:2]]


def _policy_params(cls):
    return cls(window_size=50, refinement_radius=8, min_partition_size=2)


def _rows(idx):
    st = idx.store
    return {int(r): set(np.asarray(st.get_partition(int(r))[1]).tolist())
            for r in st.active_rows()}


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_decisions_match_jax(aged_jax, monkeypatch, tmp_path, host):
    """The same window makes the same splits and deletes (the aged rows,
    after the simulated reassignment), and leaves the same partitions, in
    both packages: batched 2-means and refinement on the device, or
    kmeans_np and lloyd_refine_np with QUAKE_TPU_MAINT_HOST=1 (the same
    numpy code). The saved grid reaches both policies. The port's decision
    is one array pass with a quake.maint.reject span for each rejection
    candidate."""
    if host:
        monkeypatch.setenv("QUAKE_TPU_MAINT_HOST", "1")
    path, hot = aged_jax
    j, t = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    j.initialize_maintenance_policy(_policy_params(JaxPolicyParams))
    t.initialize_maintenance_policy(_policy_params(MaintenancePolicyParams))
    assert t.maintenance_policy.cost_estimator.latency_estimator.grid_source == "csv"
    for _ in range(60):
        j.maintenance_policy.record_query_hits(hot)
        t.maintenance_policy.record_query_hits(hot)
    ntotal = t.ntotal()
    wi = j.maintenance()
    with device_trace(str(tmp_path)):
        ti = t.maintenance()
    assert (ti.n_splits, ti.n_deletes) == (wi.n_splits, wi.n_deletes)
    assert ti.n_splits > 0 and ti.n_deletes > 0
    assert t.maintenance_policy.rejection_candidates > 0
    assert (last_spans()["quake.maint.reject"]["calls"]
            == t.maintenance_policy.rejection_candidates)
    assert (t.nlist(), t.ntotal()) == (j.nlist(), j.ntotal()) and t.ntotal() == ntotal
    assert _rows(t) == _rows(j)
    for a, b in ((t, j), (t.parent, j.parent)):
        rows = a.store.active_rows()
        np.testing.assert_array_equal(rows, b.store.active_rows())
        np.testing.assert_allclose(a.store.state.centroids.numpy()[rows],
                                   np.asarray(b.store.state.centroids)[rows],
                                   rtol=1e-5, atol=1e-5)
    assert t.validate() and t.parent.ntotal() == t.nlist()
    _contract_6(t.store)
    _contract_6(t.parent.store)


# ------------------------------------------------------------- hit windows


@pytest.fixture(scope="module")
def window_pair_path(tmp_path_factory):
    """A JAX index over a clustered corpus (8000 x 16, 48 partitions),
    saved, with the fields of an APS calibration set by hand (a radius model
    of the nearest-centroid distance, a oneshot cap, a dense width)."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((40, 16)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 40, 8000)]
         + rng.standard_normal((8000, 16)).astype(np.float32))
    q = (centers[rng.integers(0, 40, 64)]
         + rng.standard_normal((64, 16)).astype(np.float32))
    j = JaxIndex()
    j.build(x, np.arange(8000), JaxBuildParams(nlist=48, calibrate_aps=False))
    j.aps_radius_ab = np.tile(np.array([[0.2, 1.0]], np.float32), (20, 1))
    j.aps_oneshot_mcap, j.aps_dense_w, j.aps_calib_target = 16, 6, 0.9
    path = str(tmp_path_factory.mktemp("window") / "idx")
    j.save(path)
    return path, q.astype(np.float32)


PATHS = {
    "fused": (64, dict(k=10, nprobe=6)),
    "query_major": (8, dict(k=10, nprobe=6)),
    "unfused_batched": (8, dict(k=10, nprobe=6, batched_scan=True)),
    "oneshot": (64, dict(k=10, recall_target=0.95, aps_mode="oneshot")),
    "planned": (64, dict(k=10, recall_target=0.95, aps_mode="planned")),
    "loop": (64, dict(k=10, recall_target=0.95, aps_mode="loop")),
    "dense": (64, dict(k=10, recall_target=0.9, aps_mode="dense")),
}


@pytest.mark.parametrize("path_name", list(PATHS))
def test_search_windows_match_jax(window_pair_path, monkeypatch, path_name):
    """Each search path records, query by query, the same hit partitions and
    scanned sizes as the JAX package's (the APS scans pinned to "xla" in
    both, as tests/test_torch_aps.py pins them)."""
    if path_name in ("oneshot", "planned", "loop"):
        monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    path, q = window_pair_path
    B, kw = PATHS[path_name]
    j, t = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    for idx, cls in ((j, JaxPolicyParams), (t, MaintenancePolicyParams)):
        idx.initialize_maintenance_policy(cls(window_size=4096))
    j.search(q[:B], JaxSearchParams(**kw))
    t.search(q[:B], SearchParams(**kw))
    sizes = t.store.partition_sizes()
    tj, tt = j.maintenance_policy.hit_count_tracker, t.maintenance_policy.hit_count_tracker
    want, got = tj.get_per_query_hits(sizes), tt.get_per_query_hits(sizes)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tt._scanned_sizes == tj._scanned_sizes
    assert all(len(g) > 0 for g in got)
