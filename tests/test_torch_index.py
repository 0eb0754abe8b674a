"""quake_tpu_torch end to end against the JAX package (CPU): k-means quality,
the whole search slice on one shared store (the default v11 scan and each
scan chosen by name), the whole slice from each package's own build, and the
scope guards.

Tolerances: the search path quantizes f32 dot products and keeps at most two
winners per fold column, exactly like the JAX path, but sums in another
order; so results compare by id overlap (>= 0.99 on a shared store) and by
recall (within 0.02 of the JAX package when each builds its own index,
whose k-means draws different random numbers). k-means inertia is compared
within 2% for the same reason.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.kmeans import kmeans_fit_assign as jax_kmeans
from quake_tpu.ops.grouped import grouped_scan_xla as jax_scan_xla
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu.ops.pallas_grouped import _global_bounds as jax_global_bounds
from quake_tpu.ops.pallas_grouped import (grouped_scan_pallas, grouped_scan_pallas_v3,
                                          grouped_scan_pallas_v3p, grouped_scan_pallas_v3pn,
                                          grouped_scan_pallas_v4, grouped_scan_pallas_v5,
                                          grouped_scan_pallas_v6, grouped_scan_pallas_v7,
                                          grouped_scan_pallas_v8, grouped_scan_pallas_v9,
                                          grouped_scan_pallas_v11)
from quake_tpu.ops.scan import flat_scan as jax_flat_scan
from quake_tpu.ops.scan import scores_to_distances as jax_scores_to_distances
from quake_tpu.storage.store import _sumsq as jax_sumsq
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy
from quake_tpu_torch import coordinator
from quake_tpu_torch.kmeans import kmeans_fit_assign
from quake_tpu_torch.utils import compute_recall, knn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("codes", "ids", "sizes", "centroids", "active", "norms")


def clustered(n, d, n_centers, seed):
    rng = np.random.default_rng(99)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3.0
    r = np.random.default_rng(seed)
    return (centers[r.integers(0, n_centers, n)]
            + r.standard_normal((n, d)).astype(np.float32))


def _inertia(x, cents, assign, metric):
    if metric == "l2":
        return float(((x - cents[assign]) ** 2).sum())
    return float(-(x * cents[assign]).sum())


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_kmeans_inertia_matches_jax(metric):
    # Many more true centres than clusters: seed-to-seed spread of the
    # inertia stays well below 1%, so 2% separates a fault from luck.
    x = clustered(6000, 16, 200, seed=1)
    jc, ja = jax_kmeans(jnp.asarray(x), 32, metric=metric, niter=10)
    tc, ta = kmeans_fit_assign(torch.from_numpy(x), 32, metric=metric, niter=10)
    ji = _inertia(x, np.asarray(jc), np.asarray(ja), metric)
    ti = _inertia(x, tc.numpy(), ta.numpy(), metric)
    assert abs(ti - ji) <= 0.02 * abs(ji), (ti, ji)
    # Final assignment is the exact nearest centroid.
    assert ta.shape == (6000,) and int(ta.max()) < 32
    if metric == "ip":
        np.testing.assert_allclose(np.linalg.norm(tc.numpy(), axis=1), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_index():
    x = clustered(20_000, 32, 200, seed=3)
    idx = JaxIndex()
    idx.build(x, np.arange(len(x)), JaxBuildParams(nlist=64, calibrate_aps=False))
    q = clustered(64, 32, 200, seed=4)
    return idx, x, q


def _arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def test_whole_slice_on_one_state(jax_index, monkeypatch):
    """The port's fused_ivf_search against the JAX main path composed of its
    own kernels in interpret mode, on the same store. The parent ranking is
    pinned to kernel K3 ("pallas"), which a CPU index does not default to."""
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    jidx, _, q = jax_index
    k, nprobe = 10, 8
    tidx = index_from_numpy(_arrays(jidx.store.state), _arrays(jidx.parent.store.state),
                            "l2", device="cpu")
    qt, group_chunk = tidx._grouped_params(len(q), nprobe)
    assert (qt, group_chunk) == jidx._grouped_params(len(q), nprobe)
    gpb = int(tidx._grouped_kernel()[len("v11g"):])
    st, pst = jidx.store.state, jidx.parent.store.state
    qj = jnp.asarray(q)
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, qj, nprobe, "l2",
                              interpret=True)
    pids = jnp.where(pids >= 0, pids, pids[:, :1])
    s1, i1, _ = grouped_scan_pallas_v11(st.codes, st.ids, st.sizes, st.norms, qj, pids,
                                        k, "l2", qt=qt, gpb=gpb, interpret=True)
    d1 = np.asarray(jax_scores_to_distances(s1, i1, "l2"))

    ts, pts = tidx.store.state, tidx.parent.store.state
    _, i2, d2, scanned, pids2 = coordinator.fused_ivf_search(
        ts.codes, ts.ids, ts.sizes, ts.norms, pts.codes, pts.ids, torch.from_numpy(q),
        k=k, nprobe=nprobe, metric="l2", qt=qt, kernel=tidx._grouped_kernel(),
        parent_norms=pts.norms, parent_kernel=tidx._parent_kernel())
    i1, i2 = np.asarray(i1), i2.numpy()
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(i1, i2)])
    assert overlap >= 0.99, overlap
    assert (scanned.numpy() == nprobe).all()
    probe_overlap = np.mean([len(set(a) & set(b)) / nprobe
                             for a, b in zip(np.asarray(pids), pids2.numpy())])
    assert probe_overlap >= 0.99
    same = i1 == i2
    np.testing.assert_allclose(d2.numpy()[same], d1[same], rtol=1e-4, atol=1e-4)

    # The user-facing search returns the same ids and reference layouts.
    res = tidx.search(q, SearchParams(k=k, nprobe=nprobe))
    np.testing.assert_array_equal(res.ids, i2.astype(np.int64))
    assert res.ids.dtype == np.int64 and res.distances.dtype == np.float32
    assert res.timing_info.partitions_scanned == nprobe
    assert res.timing_info.total_time_ns > 0


def _jax_v2(codes, ids, sizes, norms, q, pids, k, metric, qt, interpret):
    return grouped_scan_pallas(codes, ids, q, pids, k, metric, qt=qt, interpret=interpret)


def _jax_xla(codes, ids, sizes, norms, q, pids, k, metric, qt, interpret):
    """The JAX package's scan off the TPU; group_chunk only sets how many
    groups one step gathers."""
    return jax_scan_xla(codes, ids, q, pids, k, metric, qt=qt, group_chunk=64, norms=norms)


@pytest.mark.parametrize("kernel,jax_scan,kw", [
    ("v3p", grouped_scan_pallas_v3p, {}),
    ("v3p4", grouped_scan_pallas_v3pn, dict(gpb=4)),
    ("v7g4", grouped_scan_pallas_v7, dict(gpb=4)),
    ("v8g4", grouped_scan_pallas_v8, dict(gpb=4)),
    ("v9", grouped_scan_pallas_v9, dict(gpb=4)),
    # C = 512 here, so a fold of 1024 does not divide C: the v3pN fallback.
    ("v11g4f1024", grouped_scan_pallas_v3pn, dict(gpb=4)),
    ("v3", grouped_scan_pallas_v3, {}),
    ("v2", _jax_v2, {}),
    ("xla", _jax_xla, {}),
    ("v4", grouped_scan_pallas_v4, dict(ct=512, gpb=8)),  # C = 512: one chunk
    ("v4c128g8", grouped_scan_pallas_v4, dict(ct=128, gpb=8)),
    ("v5c128g2", grouped_scan_pallas_v5, dict(ct=128, gpb=2)),
    ("v6c128", grouped_scan_pallas_v6, dict(ct=128, gpb=4)),
])
def test_whole_slice_by_name(jax_index, monkeypatch, kernel, jax_scan, kw):
    """QuakeIndex.search with QUAKE_TPU_KERNEL naming the scan, against the
    JAX package's stages on the same store: the Pallas parent ranking, then
    the named Pallas scan, both in interpret mode."""
    jidx, _, q = jax_index
    k, nprobe = 10, 8
    tidx = index_from_numpy(_arrays(jidx.store.state), _arrays(jidx.parent.store.state),
                            "l2", device="cpu")
    assert tidx.store.C % 1024 != 0
    monkeypatch.setenv("QUAKE_TPU_KERNEL", kernel)
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    assert tidx._grouped_kernel() == kernel and tidx._parent_kernel() == "pallas"
    res = tidx.search(q, SearchParams(k=k, nprobe=nprobe))

    st, pst = jidx.store.state, jidx.parent.store.state
    qj = jnp.asarray(q)
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, qj, nprobe, "l2",
                              interpret=True)
    pids = jnp.where(pids >= 0, pids, pids[:, :1])
    s1, i1, _ = jax_scan(st.codes, st.ids, st.sizes, st.norms, qj, pids, k, "l2",
                         qt=tidx._grouped_params(len(q), nprobe)[0], interpret=True, **kw)
    d1 = np.asarray(jax_scores_to_distances(s1, i1, "l2"))
    i1 = np.asarray(i1)
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(i1, res.ids)])
    assert overlap >= 0.99, overlap
    same = i1 == res.ids
    np.testing.assert_allclose(res.distances[same], d1[same], rtol=1e-4, atol=1e-4)


def test_whole_slice_from_own_build(jax_index):
    jidx, x, q = jax_index
    gt, _ = knn(q, x, 10)
    tidx = QuakeIndex(device="cpu")
    t = tidx.build(x, np.arange(len(x)), IndexBuildParams(nlist=64, calibrate_aps=False))
    assert tidx.ntotal() == len(x) and tidx.d() == 32 and tidx.nlist() >= 64
    assert t.n_clusters == tidx.nlist() and tidx.aps_dimension > 0
    for nprobe in (4, 8):
        rj = compute_recall(jidx.search(q, JaxSearchParams(k=10, nprobe=nprobe)).ids, gt, 10)
        rt = compute_recall(tidx.search(q, SearchParams(k=10, nprobe=nprobe)).ids, gt, 10)
        assert abs(rt - rj) <= 0.02, (nprobe, rt, rj)
    # Full probe finds (almost) every true neighbour.
    r_all = compute_recall(tidx.search(q, SearchParams(k=10, nprobe=tidx.nlist())).ids, gt, 10)
    assert r_all >= 0.98


def test_reference_kernel_is_exact_over_probed_partitions(jax_index):
    _, x, q = jax_index
    tidx = QuakeIndex(device="cpu")
    tidx.build(x[:5000], None, IndexBuildParams(nlist=16, metric="ip", calibrate_aps=False))
    st, pst = tidx.store.state, tidx.parent.store.state
    qt = torch.from_numpy(q)
    _, i1, _, _, _ = coordinator.fused_ivf_search(
        st.codes, st.ids, st.sizes, st.norms, pst.codes, pst.ids, qt, k=10,
        nprobe=tidx.nlist(), metric="ip", qt=8, kernel="reference", parent_norms=pst.norms)
    gt, _ = knn(q, x[:5000], 10, metric="ip")
    assert compute_recall(i1.numpy(), gt, 10) == 1.0


def _small_index(**kw):
    x = clustered(2000, 8, 20, seed=5)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=8, calibrate_aps=False, **kw))
    return idx, x


@pytest.mark.parametrize("kw,match", [
    # Lifted: a bf16 build runs and is held to the JAX package's rounding
    # (the case keeps the id it had as a guard).
    pytest.param(dict(precision="bf16"), None, id="kw0-ROADMAP Queue 1 item 5: bf16 codes"),
    # Lifted: a spilled build runs (the case keeps the id it had as a guard).
    pytest.param(dict(spill=True), None, id="kw1-ROADMAP Queue 1 item 6: spill and dedup"),
    # Lifted: a sharded build runs (the case keeps the id it had as a guard).
    pytest.param(dict(num_shards=2), None, id="kw2-ROADMAP Queue 1 item 11: parallel"),
    # Lifted: the build profiles the grouped scan's latency grid and sets
    # the maintenance policy on it (the case keeps the id it had as a guard).
    pytest.param(dict(profile_maintenance_latency=True), None,
                 id="kw3-ROADMAP Queue 1 item 8: maintenance"),
    # Lifted: a parent that is itself an IVF builds (the case keeps the id
    # it had as a guard).
    pytest.param(dict(parent_params=IndexBuildParams(nlist=4)), None,
                 id="kw4-ROADMAP Queue 1 item 10: multi-level"),
])
def test_build_guards(kw, match, monkeypatch):
    """Each guard names the ROADMAP item that lifts it, by number and title
    (ROADMAP Queue 3 fault 7). A lifted guard's case checks the build
    instead: precision="bf16" stores the f32 build's codes (the same
    clustering) rounded as the JAX package rounds them (jnp.asarray(x,
    bfloat16)), bit for bit, and the f32 squared norms of the rounded codes
    (its _sumsq; rtol 1e-6, a sum in another order);
    profile_maintenance_latency=True profiles the grid (here a 2 x 2 grid
    in place of the default 10 x 5, the "xla" scan on the CPU) and the
    build's policy reads it; spill=True stores the unspilled build's
    clustering (the same seeded k-means) with each vector's second copy in
    the partition soar_assign gives it (test_torch_spill.py holds the whole
    build to the JAX package's); parent_params with nlist 4 stores the
    two-level build's clustering at the leaf (the same seeded k-means) under
    an IVF parent of 4 partitions over its 8 centroids, itself over a flat
    parent, every level valid (test_torch_multilevel.py holds the index to
    the JAX package's); num_shards=2 stores the unsharded build's
    clustering (the same seeded k-means) with C rounded to a multiple of 256
    (each of the two shards' slot slices a multiple of 128), on a mesh of two
    virtual CPU shards, and searches as it does under "xla"
    (test_torch_sharded.py holds sharding to the JAX package's)."""
    if kw.get("num_shards"):
        idx, x = _small_index(**kw)
        ref, _ = _small_index()
        assert idx.mesh.size == 2 and idx.store.C % 256 == 0 and idx.store.C >= ref.store.C
        st, rst = idx.store.state, ref.store.state
        C0 = ref.store.C
        for name in ("codes", "ids", "norms"):
            assert torch.equal(getattr(st, name)[:, :C0], getattr(rst, name))
        assert (st.ids[:, C0:] == -1).all()
        for name in ("sizes", "centroids", "active"):
            assert torch.equal(getattr(st, name), getattr(rst, name))
        monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
        for nq in (32, 4):
            sp = SearchParams(k=5, nprobe=3)
            np.testing.assert_array_equal(idx.search(x[:nq], sp).ids, ref.search(x[:nq], sp).ids)
        return
    if kw.get("profile_maintenance_latency"):
        from quake_tpu_torch.maintenance import latency_estimator

        monkeypatch.setattr(latency_estimator, "DEFAULT_LATENCY_ESTIMATOR_RANGE_N", [64, 256])
        monkeypatch.setattr(latency_estimator, "DEFAULT_LATENCY_ESTIMATOR_RANGE_K", [1, 8])
        idx, _ = _small_index(**kw)
        est = idx.latency_profile
        assert est.grid_source == "profiled" and (est.latency_grid > 0).all()
        assert est.latency_grid.shape == (2, 2) and est.d == 8
        assert idx.maintenance_policy.cost_estimator.latency_estimator is est
        return
    if kw.get("spill"):
        from quake_tpu_torch.kmeans import soar_assign

        idx, x = _small_index(**kw)
        ref, _ = _small_index()
        ids = np.arange(len(x))
        prim = ref.store.id_map.get_batch(ids)
        np.testing.assert_array_equal(idx.store.id_map.get_batch(ids), prim)
        cents = ref.store.state.centroids.numpy()[:ref.nlist()]
        _, spill = soar_assign(x, cents, 1.0, primary=prim)
        np.testing.assert_array_equal(idx.store.spill_map.get_batch(ids), spill)
        assert idx.spill and idx.validate() and int(idx.store.state.sizes.sum()) == 2 * len(x)
        return
    if kw.get("parent_params"):
        idx, _ = _small_index(**kw)
        ref, _ = _small_index()
        np.testing.assert_array_equal(idx.store.state.codes.numpy(),
                                      ref.store.state.codes.numpy())
        mid = idx.parent
        assert mid.level == 1 and mid.nlist() == 4 and mid.parent.parent is None
        assert mid.ntotal() == idx.nlist() == 8 and mid.maintenance_policy is not None
        np.testing.assert_array_equal(mid.get(np.arange(8)), ref.parent.get(np.arange(8)))
        assert idx.validate() and mid.validate() and mid.parent.validate()
        return
    if match is None:
        idx, _ = _small_index(**kw)
        ref, _ = _small_index()
        codes = ref.store.state.codes.numpy()
        st = idx.store.state
        assert st.codes.dtype == torch.bfloat16
        np.testing.assert_array_equal(st.codes.view(torch.int16).numpy(),
                                      np.asarray(jnp.asarray(codes, jnp.bfloat16)).view(np.int16))
        np.testing.assert_allclose(st.norms.numpy(),
                                   np.asarray(jax_sumsq(jnp.asarray(codes), jnp.bfloat16)),
                                   rtol=1e-6, atol=0)
        return
    with pytest.raises(NotImplementedError, match=match):
        _small_index(**kw)


@pytest.mark.parametrize("scan", ["v3p", "v3p4", "v6", "v7g4", "v4", "v5", "v3", "v2",
                                  "approx", "sized", "packed", "multi"])
def test_bf16_refusals(monkeypatch, scan):
    """Lifted (the name and the 12 cases kept as they were): every scan
    whose kernel had no bf16 body (K4-K9, sized_topk, multi_topk) runs on a
    bf16 store. Each by-name scan through QuakeIndex.search (its ids within
    the probed partitions, row overlap >= 0.95 with the exact "xla" scan of
    the same index) and each scan, by name or direct, on the store's
    tensors with the same probe lists in both packages, held to the JAX
    package's interpret-mode Pallas run with its f32 test's tolerance
    (test_torch_bf16_scans.py::assert_scan_matches)."""
    from test_torch_bf16_scans import BY_NAME, assert_scan_matches, run_scan

    idx, x = _small_index(precision="bf16")
    st = idx.store.state
    assert st.codes.dtype == torch.bfloat16
    if scan in BY_NAME:
        sp = SearchParams(k=5, nprobe=2)
        monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
        exact = idx.search(x[:32], sp).ids
        monkeypatch.setenv("QUAKE_TPU_KERNEL", scan)
        got = idx.search(x[:32], sp).ids
        assert got.shape == (32, 5) and (got >= 0).all()
        assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, exact)]) >= 0.95
    rng = np.random.default_rng(7)
    P = st.codes.shape[0]
    pids = np.stack([rng.permutation(P)[:2] for _ in range(32)]).astype(np.int32)
    arrays = {f: np.asarray(jnp.asarray(st.codes.float().numpy(), jnp.bfloat16)) if f == "codes"
              else getattr(st, f).numpy() for f in ("codes", "ids", "sizes", "norms")}
    want, got = run_scan(monkeypatch, scan, arrays, st, x[:32], pids, 5, "l2")
    assert_scan_matches(scan, want, got, arrays["ids"], pids)


def test_num_workers_builds_plain_on_one_device(monkeypatch):
    """ROADMAP Queue 3 fault 8: as in the JAX package, num_workers > 1
    shards only where there are that many devices; a CPU index counts as
    one, so it builds plain and searches as num_workers=0 does. A CUDA index
    with as many CUDA devices plans that many shards (the count
    monkeypatched; the build itself runs on the card, in
    test_torch_cuda.py::test_sharded_index_on_the_card_matches_its_cpu_load),
    and with fewer plans none; num_shards plans its own count anywhere."""
    idx2, x = _small_index(num_workers=2)
    idx0, _ = _small_index()
    sp = SearchParams(k=5, nprobe=3)
    for nq in (32, 4):
        a, b = idx2.search(x[:nq], sp), idx0.search(x[:nq], sp)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.distances, b.distances)
    assert idx2.mesh is None and idx2._shard_plan(IndexBuildParams(num_workers=2)) == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card = QuakeIndex(device="cuda")
    assert card._shard_plan(IndexBuildParams(nlist=8, num_workers=2)) == 2
    assert card._shard_plan(IndexBuildParams(nlist=8, num_workers=3)) == 0  # too few cards
    assert card._shard_plan(IndexBuildParams(nlist=8, num_shards=4)) == 4
    assert idx2._shard_plan(IndexBuildParams(nlist=8, num_shards=4)) == 4


def test_guard_messages_cite_current_items():
    """The search and scan guards name their ROADMAP items (fault 7). The
    APS guard is lifted: a recall-target search runs and adheres (recall@5
    >= target - 0.05, the JAX package's margin), also over a parent that is
    itself an IVF (the guard of item 10, lifted). The
    exact_distances=False guards are lifted: the search runs, and v11 with
    exact=False returns the JAX package's ids and dequantized scores on the
    same store (interpret-mode Pallas; row overlap >= 0.99, scores of the
    common ids within one quantization step, grange / levels). The
    bounds="sampled" guard is lifted: the port's bounds equal the JAX
    package's _global_bounds on the same store (rtol 1e-5)."""
    from quake_tpu_torch.ops.grouped_scan import global_bounds, grouped_scan_v11, packed_params

    idx, x = _small_index()
    res = idx.search(x[:32], SearchParams(k=5, recall_target=0.9))
    gt, _ = knn(x[:32], x, 5)
    assert compute_recall(res.ids, gt, 5) >= 0.9 - 0.05
    nested, _ = _small_index(parent_params=IndexBuildParams(nlist=4))
    res = nested.search(x[:32], SearchParams(k=5, recall_target=0.9))
    assert compute_recall(res.ids, gt, 5) >= 0.9 - 0.05
    res = idx.search(x[:32], SearchParams(k=5, exact_distances=False))
    assert res.ids.shape == (32, 5) and (res.ids >= 0).all()
    q = torch.from_numpy(x[:16])
    st = idx.store.state
    got = global_bounds(q, st.norms, "l2", bounds="sampled", codes=st.codes, sizes=st.sizes)
    want = jax_global_bounds(*(jnp.asarray(t.numpy()) for t in (q, st.codes, st.norms, st.sizes)),
                             "l2", "sampled")
    np.testing.assert_allclose([float(a) for a in got], [float(a) for a in want], rtol=1e-5)
    pids = np.stack([np.random.default_rng(b).permutation(idx.nlist())[:2]
                     for b in range(16)]).astype(np.int32)
    s_t, i_t, _ = grouped_scan_v11(st.codes, st.ids, st.sizes, st.norms, q,
                                   torch.from_numpy(pids), 5, "l2", qt=8, exact=False)
    s_j, i_j, _ = grouped_scan_pallas_v11(*(jnp.asarray(t.numpy()) for t in (
        st.codes, st.ids, st.sizes, st.norms, q)), jnp.asarray(pids), 5, "l2", qt=8,
        interpret=True, exact=False)
    s_t, i_t, s_j, i_j = s_t.numpy(), i_t.numpy(), np.asarray(s_j), np.asarray(i_j)
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(i_t, i_j)]) >= 0.99
    _, grange = global_bounds(q, st.norms, "l2")
    step = float(grange) / packed_params(idx.store.C)[1]
    for a, sa, b, sb in zip(i_t, s_t, i_j, s_j):
        theirs = dict(zip(b.tolist(), sb.tolist()))
        for i, s in zip(a.tolist(), sa.tolist()):
            if i in theirs:
                assert abs(s - theirs[i]) <= step


def test_calibrate_aps_guard():
    """The guard is lifted: a default build (calibrate_aps=True) of 10,000
    vectors calibrates APS, as the JAX package's does, and its recall-target
    search adheres; calibrate_aps=False leaves the defaults."""
    x = clustered(10_000, 8, 20, seed=5)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=8))
    assert idx.aps_plan_width > 0 and idx.aps_calib_target == 0.9 and idx.aps_calib_nq > 0
    assert idx.aps_radius_ab is not None and idx.aps_radius_ab.shape[1] == 2
    res = idx.search(x[:64], SearchParams(k=10, recall_target=0.9))
    gt, _ = knn(x[:64], x, 10)
    assert compute_recall(res.ids, gt, 10) >= 0.9 - 0.05
    off = QuakeIndex(device="cpu")
    off.build(x, None, IndexBuildParams(nlist=8, calibrate_aps=False))
    assert off.aps_plan_width == 0 and off.aps_radius_ab is None and off.aps_calib_nq == 0


@pytest.mark.parametrize("sp,nq", [
    (SearchParams(k=5, nprobe=2, recall_target=0.9), 32),
    (SearchParams(k=5, nprobe=2, exact_distances=False), 32),
    (SearchParams(k=5, nprobe=2), 15),
    (SearchParams(k=5, nprobe=2, batched_scan=False), 32),
])
def test_search_guards(sp, nq):
    """APS is no longer guarded: the recall-target search runs and adheres
    (recall@5 >= target - 0.05 against the exact neighbors); batches below
    16 queries and batched_scan=False take the query-major search, which is
    exact over the probed partitions (every stored vector finds itself). Dequantized distances are no longer
    guarded: with pool_factor 1 they keep the exact search's winners (the
    same id set a row, as the JAX package's test_v10_dequantized_scores
    holds) and their distances within one quantization step."""
    idx, x = _small_index()
    if sp.recall_target > 0:
        res = idx.search(x[:nq], sp)
        gt, _ = knn(x[:nq], x, sp.k)
        assert res.ids.shape == (nq, sp.k)
        assert compute_recall(res.ids, gt, sp.k) >= sp.recall_target - 0.05
        assert 1 <= res.timing_info.partitions_scanned <= idx.nlist()
        return
    if not sp.exact_distances:
        from quake_tpu_torch.ops.grouped_scan import global_bounds, packed_params

        res = idx.search(x[:nq], sp)
        exact = idx.search(x[:nq], SearchParams(k=sp.k, nprobe=sp.nprobe))
        for a, b in zip(res.ids, exact.ids):
            assert set(a.tolist()) == set(b.tolist())
        q = torch.from_numpy(x[:nq])
        _, grange = global_bounds(q, idx.store.state.norms, "l2")
        step = float(grange) / packed_params(idx.store.C)[1]
        sq = lambda r: np.sort(-r.distances ** 2, axis=1)  # the scores, squared l2
        assert np.abs(sq(res) - sq(exact)).max() <= step
        return
    res = idx.search(x[:nq], sp)
    assert res.ids.shape == (nq, sp.k) and res.timing_info.partitions_scanned == sp.nprobe
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(nq))
    np.testing.assert_allclose(res.distances[:, 0], 0.0, atol=1e-2)


def test_flat_index_search_guard_and_dimension_check():
    idx, x = _small_index()
    with pytest.raises(ValueError, match="query dimension"):
        idx.search(np.zeros((32, 3), np.float32), SearchParams(k=1))
    flat = QuakeIndex(device="cpu")
    flat.build(x, None, IndexBuildParams(nlist=0))
    # exact_distances=False leaves a flat index exact, as in the JAX
    # package: its fused_flat_search, the same ids as the JAX flat scan's.
    inexact = flat.search(x[:32], SearchParams(k=1, exact_distances=False))
    exact = flat.search(x[:32], SearchParams(k=1))
    np.testing.assert_array_equal(inexact.ids, exact.ids)
    np.testing.assert_array_equal(inexact.distances, exact.distances)
    st = flat.store.state
    _, jids = jax_flat_scan(jnp.asarray(x[:32]), jnp.asarray(st.codes.numpy()[0]),
                            jnp.asarray(st.ids.numpy()[0]), 1, "l2")
    np.testing.assert_array_equal(inexact.ids, np.asarray(jids))
    # A flat index is exact, and has no APS to guard: the target is ignored.
    res = flat.search(x[:32], SearchParams(k=5, recall_target=0.9))
    gt, _ = knn(x[:32], x, 5)
    assert compute_recall(res.ids, gt, 5) == 1.0
    assert res.timing_info.partitions_scanned == flat.nlist() == 1


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuakeIndex()


def test_kernel_wrappers_reject_other_devices():
    from quake_tpu_torch.ops.grouped_scan import merge_positions

    with pytest.raises(ValueError, match="unsupported device"):
        merge_positions(torch.zeros((2, 128), device="meta"), 4, 128)


def test_imports_without_jax():
    """The port imports neither jax nor quake_tpu, in any module."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import quake_tpu_torch
        for m in pkgutil.walk_packages(quake_tpu_torch.__path__, "quake_tpu_torch."):
            importlib.import_module(m.name)
        bad = [m for m in sys.modules if m == "quake_tpu" or m.startswith("quake_tpu.")
               or m == "jax" and sys.modules[m] is not None]
        assert not bad, bad
        from quake_tpu_torch.native import idmap
        assert idmap._lib is None  # nothing is built at import
        for m in ("coordinator", "ops.grouped", "ops.grouped_family", "ops.grouped_scan",
                  "ops.grouped_exact", "ops.grouped_chunked", "ops.grouped_variants",
                  "native", "native.idmap", "wrappers.quake", "wrappers.faiss_ivf",
                  "workload.generator", "workload.evaluator", "datasets", "debug",
                  "profiling"):
            assert "quake_tpu_torch." + m in sys.modules, m
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
