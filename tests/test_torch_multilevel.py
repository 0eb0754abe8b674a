"""An index of three levels (IndexBuildParams(parent_params=
IndexBuildParams(nlist > 1)): the leaf, an IVF parent over its centroids and
a flat grandparent) in the port against the JAX package, on the CPU.

The JAX package builds one such index (tests/test_index.py::
test_multi_level_index's inputs and parameters: 10,000 x 32, nlist 64, a
parent of nlist 8) and saves it; each test loads a fresh copy into both
packages, so both run on the same stores at every level.

What is held, and how closely:
  * the route: a parent that is itself an IVF is searched by the unfused
    path at every level (quake_tpu/index.py:855-860, :1162-1167), the leaf
    of a fixed-nprobe search on the "xla" scan, exact in both packages:
    row overlap of ids >= 0.99 and recall@10 within 0.01 of the JAX
    package's; the hit window of each IVF level equal to the JAX package's
    (the mid level records its own);
  * APS at target 0.9 (fraction 0.5, the JAX test's): recall@10 >= 0.85 in
    both; every aps_mode in the port;
  * mutation through the IVF parent: a flood that splits a leaf partition
    (host kmeans_np in both, so the parent's remove and add run the IVF
    mid level's own add and remove), then a remove: every level's arrays,
    bookkeeping and id map equal (the store's own tolerances), validate()
    and contract 6 at every level;
  * maintenance(): the same window makes the same splits and deletes and
    leaves the same ids in every leaf partition, centroids of every level
    within 1e-5 (tests/test_torch_maintenance.py's decision parity);
  * save and load both ways, and index_from_numpy over a chain of parents:
    every level equal, search ids equal;
  * the port's own build: three levels, each IVF level with its policy,
    calibration where the JAX package calibrates (n >= 10,000) only.
"""

import numpy as np
import pytest
import torch

from conftest import make_data
from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import MaintenancePolicyParams as JaxPolicyParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator as JaxLatency
from quake_tpu_torch import (IndexBuildParams, MaintenancePolicyParams, QuakeIndex, SearchParams,
                             index_from_numpy)
from quake_tpu_torch.maintenance import ListScanLatencyEstimator
from quake_tpu_torch.utils import compute_recall, knn
from test_torch_spill import carry_store
from test_torch_store_mutation import _assert_same, _contract_6

N, D, NLIST, MID = 10_000, 32, 64, 8


def _x():
    return make_data(N, D, seed=1)


def _q():
    return make_data(100, D, seed=2)


@pytest.fixture(scope="module")
def saved_jax(tmp_path_factory):
    """The JAX package's three-level index, built with the default
    parameters of tests/test_index.py::test_multi_level_index and saved."""
    j = JaxIndex()
    j.build(_x(), np.arange(N, dtype=np.int64),
            JaxBuildParams(nlist=NLIST, parent_params=JaxBuildParams(nlist=MID)))
    path = str(tmp_path_factory.mktemp("jax_multilevel") / "idx")
    j.save(path)
    return path


def _pair(path):
    return JaxIndex().load(path), QuakeIndex(device="cpu").load(path)


def _levels(idx):
    out = []
    while idx is not None:
        out.append(idx)
        idx = idx.parent
    return out


def assert_same_levels(j, t):
    """Every level's store, bookkeeping and id map equal, validate() and
    contract 6 at every level, the parents one entry per partition."""
    jl, tl = _levels(j), _levels(t)
    assert len(tl) == len(jl) == 3
    for a, b in zip(jl, tl):
        assert b.level == a.level
        _assert_same(a.store, b.store)
        _contract_6(b.store)
        assert b.validate() and a.validate()
    for b in tl[:-1]:
        assert b.parent.ntotal() == b.nlist()


def _overlap(a, b, k=10):
    return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])


def test_multi_level_index(saved_jax):
    """tests/test_index.py::test_multi_level_index through both packages on
    one store: the caller's nprobe reaches the mid level, and so does the
    recall target of APS."""
    j, t = _pair(saved_jax)
    assert t.parent.parent is not None and t.parent.parent.parent is None
    assert (t.parent.level, t.parent.parent.level) == (1, 2) and t.parent.nlist() == MID
    q = _q()
    gt, _ = knn(q, _x(), 10, "l2")
    rj = j.search(q, JaxSearchParams(k=10, nprobe=32))
    rt = t.search(q, SearchParams(k=10, nprobe=32))
    assert _overlap(rt.ids, rj.ids) >= 0.99
    assert abs(compute_recall(rt.ids, gt, 10) - compute_recall(rj.ids, gt, 10)) <= 0.01
    assert compute_recall(rt.ids, gt, 10) >= 0.9
    assert rt.timing_info.partitions_scanned == 32
    # Each IVF level records its own window, as the JAX package's does.
    for a, b in zip(_levels(j)[:2], _levels(t)[:2]):
        assert (b.maintenance_policy.hit_count_tracker.get_num_queries_recorded()
                == a.maintenance_policy.hit_count_tracker.get_num_queries_recorded() == 100)
    aps_j = j.search(q, JaxSearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5))
    aps_t = t.search(q, SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5))
    assert compute_recall(aps_j.ids, gt, 10) >= 0.85
    assert compute_recall(aps_t.ids, gt, 10) >= 0.85
    assert t.validate() and j.validate()


@pytest.mark.parametrize("mode", ["auto", "oneshot", "planned", "loop"])
def test_aps_modes_through_an_ivf_parent(saved_jax, mode):
    """Every aps_mode over an IVF parent: the parent searched at the boosted
    target (no fused oneshot: the parent is not flat), recall@10 >= 0.85 at
    target 0.9; the fixed-nprobe B=16 search (the fused path's size) takes
    the unfused route too."""
    _, t = _pair(saved_jax)
    q = _q()
    gt, _ = knn(q, _x(), 10, "l2")
    r = t.search(q, SearchParams(k=10, recall_target=0.9, aps_mode=mode,
                                 initial_search_fraction=0.5))
    assert compute_recall(r.ids, gt, 10) >= 0.85
    assert 0 < r.timing_info.partitions_scanned <= NLIST // 2
    assert r.timing_info.parent_info.n_clusters == MID
    r16 = t.search(q[:16], SearchParams(k=10, nprobe=16))
    assert r16.ids.shape == (16, 10) and (r16.ids >= 0).all()


def test_mutation_through_an_ivf_parent(saved_jax):
    """A flood that overflows one leaf partition splits it (host kmeans_np
    in both packages); the parent's remove and add run on the mid level's
    IVF store; then a remove. Every level equal after each step."""
    j, t = _pair(saved_jax)
    x = _x()
    C0, nlist0 = t.store.C, t.nlist()
    flood = (x[7] + 0.05 * np.random.default_rng(3).standard_normal(
        (int(2.5 * C0), D))).astype(np.float32)
    new_ids = np.arange(100_000, 100_000 + len(flood), dtype=np.int64)
    j.add(flood, new_ids)
    t.add(flood, new_ids)
    assert t.nlist() > nlist0 and t.store.C == C0
    assert_same_levels(j, t)
    gone = np.concatenate([np.arange(0, 500), new_ids[::3]])
    j.remove(gone)
    t.remove(gone)
    assert t.ntotal() == N + len(flood) - len(gone)
    assert_same_levels(j, t)
    q = _q()
    rj = j.search(q, JaxSearchParams(k=10, nprobe=32))
    rt = t.search(q, SearchParams(k=10, nprobe=32))
    assert _overlap(rt.ids, rj.ids) >= 0.99


def _rows(idx):
    """{active row: its set of ids}, from one host copy of the id slab."""
    st = idx.store
    ids = np.asarray(st.state.ids.cpu() if isinstance(st.state.ids, torch.Tensor)
                     else st.state.ids)
    return {int(r): set(ids[r][ids[r] >= 0].tolist()) for r in st.active_rows()}


def test_maintenance_through_an_ivf_parent(saved_jax):
    """maintenance() on a three-level index: the same window (hot rows and
    the aged ones, recorded on the host) under a steep latency grid (L =
    2000 n + k ns, as tests/test_torch_maintenance.py::aged_jax's) makes
    the same
    splits and deletes
    in both packages; the mid level takes the centroids' removes, adds and
    modifies; every level valid."""
    j, t = _pair(saved_jax)
    for idx, cls in ((j, JaxLatency), (t, ListScanLatencyEstimator)):
        grid = cls(D, packaged=False)  # steep: L = 2000 n + k ns
        grid.latency_grid = np.array([[n * 2000.0 + k for k in grid.k_values]
                                      for n in grid.n_values])
        idx.latency_profile = grid
    params = dict(window_size=50, refinement_radius=8, min_partition_size=2)
    j.initialize_maintenance_policy(JaxPolicyParams(**params))
    t.initialize_maintenance_policy(MaintenancePolicyParams(**params))
    sizes = t.store.partition_sizes()
    active = t.store.active_rows()
    order = active[np.argsort(sizes[active], kind="stable")]
    for r in order[:2]:  # two partitions age out
        _, vids = t.store.get_partition(int(r))
        j.remove(vids[2:])
        t.remove(vids[2:])
    rest = order[2:]  # hot: the two rows nearest the mean size (aged_jax's choice)
    near = rest[np.argsort(np.abs(sizes[rest] - sizes[rest].mean()), kind="stable")]
    hot = [int(r) for r in near[:2]]
    for _ in range(60):
        j.maintenance_policy.record_query_hits(hot)
        t.maintenance_policy.record_query_hits(hot)
    wi, ti = j.maintenance(), t.maintenance()
    assert (ti.n_splits, ti.n_deletes) == (wi.n_splits, wi.n_deletes)
    assert ti.n_splits > 0 and ti.n_deletes > 0
    assert (t.nlist(), t.ntotal()) == (j.nlist(), j.ntotal())
    assert _rows(t) == _rows(j)
    for a, b in zip(_levels(t), _levels(j)):
        rows = a.store.active_rows()
        np.testing.assert_array_equal(rows, b.store.active_rows())
        np.testing.assert_allclose(a.store.state.centroids.numpy()[rows],
                                   np.asarray(b.store.state.centroids)[rows],
                                   rtol=1e-5, atol=1e-5)
        assert a.validate()
        _contract_6(a.store)
    assert t.parent.ntotal() == t.nlist() and t.parent.parent.ntotal() == t.parent.nlist()


def test_save_load_both_ways_and_convert(saved_jax, tmp_path):
    """The port saves a three-level index that the JAX package loads, and
    loads what the JAX package saved (parent/parent/ in the JAX directory
    format); index_from_numpy takes the chain of parent stores."""
    j, t = _pair(saved_jax)
    assert_same_levels(j, t)
    t.save(str(tmp_path / "port"))
    back_j = JaxIndex().load(str(tmp_path / "port"))
    assert_same_levels(back_j, t)
    carried = index_from_numpy(carry_store(j.store),
                               [carry_store(j.parent.store), carry_store(j.parent.parent.store)],
                               j.metric, device="cpu")
    assert_same_levels(j, carried)
    assert carried.parent.maintenance_policy is not None
    assert carried.parent.parent.maintenance_policy is None
    q = _q()
    want = j.search(q, JaxSearchParams(k=10, nprobe=16)).ids
    for idx in (t, carried):
        np.testing.assert_array_equal(idx.search(q, SearchParams(k=10, nprobe=16)).ids, want)


def test_port_builds_three_levels():
    """The port's own build of the same parameters: an IVF parent at level 1
    (its own flat parent, store and policy), calibration at the leaf only
    (the mid level holds 64 vectors, below 10,000), search recall as the JAX
    test asks."""
    t = QuakeIndex(device="cpu")
    t.build(_x(), np.arange(N, dtype=np.int64),
            IndexBuildParams(nlist=NLIST, parent_params=IndexBuildParams(nlist=MID)))
    levels = _levels(t)
    assert [lv.level for lv in levels] == [0, 1, 2]
    assert t.parent.nlist() == MID and t.parent.ntotal() == NLIST
    assert t.parent.maintenance_policy is not None and levels[2].maintenance_policy is None
    assert t.parent.aps_calib_nq == 0 and t.parent.aps_dimension > 0
    assert all(lv.validate() for lv in levels)
    for lv in levels:
        _contract_6(lv.store)
    q = _q()
    gt, _ = knn(q, _x(), 10, "l2")
    assert compute_recall(t.search(q, SearchParams(k=10, nprobe=32)).ids, gt, 10) >= 0.9
    r = t.search(q, SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5))
    assert compute_recall(r.ids, gt, 10) >= 0.85
    assert isinstance(t.store.state.codes, torch.Tensor)
