"""Sharding (quake_tpu_torch/parallel/) against the JAX package, on the CPU.

Each case of tests/test_sharded.py runs on both packages from the same numpy
seeds: the JAX package on its 8 virtual CPU devices (conftest.py), the port
on `shard(8)` over 8 virtual CPU shards (one process; the mesh's first
device holds the merged results). Where both search one store, the JAX
package builds it and saves it, and each package loads its own copy.

What is held, and how closely:
  * under QUAKE_TPU_KERNEL=xla in both packages (the JAX package's scan off
    a TPU): the port's sharded ids equal the JAX package's sharded ids, the
    distances within rtol = atol = 1e-5 (1e-4 for oneshot, as in the JAX
    test: the shards group the pairs otherwise, so the products sum in
    another order), and partitions_scanned equal;
  * under the port's default v11 (a CPU index runs it where the JAX package
    runs "xla"): the sharded ids overlap the port's unsharded ids at >= 0.99
    (mean over rows). v11's key levels follow C, and a shard's C is C / 8:
    its keys are finer. Where the unsharded keys lose ids to ties (the
    APS cases on the clustered corpus: 0.9875 against the exact scan), the
    sharded ids are held to the exact scan's instead, at >= 0.99 and at
    least as close as the unsharded ones;
  * sharded_kmeans_step: the new centroids within 1e-4 of the JAX
    package's, the assignments equal;
  * the mesh: make_mesh's truncation to the CUDA devices there are (the
    count monkeypatched: torch.device("cuda:1") needs no card), repeated
    devices, the divisibility ValueErrors, slot shards contiguous and equal
    to the primary's slices after every write, and no jax or quake_tpu
    import under parallel/.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import MaintenancePolicyParams as JaxMaintParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.coordinator import aps_search as jax_aps_search
from quake_tpu.ops.scan import flat_scan as jax_flat_scan
from quake_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quake_tpu.parallel.mesh import shard_store_state as jax_shard_store_state
from quake_tpu.parallel.sharded import sharded_aps_search as jax_sharded_aps_search
from quake_tpu.parallel.sharded import sharded_ivf_search as jax_sharded_ivf_search
from quake_tpu.parallel.sharded import sharded_kmeans_step as jax_sharded_kmeans_step
from quake_tpu_torch import IndexBuildParams, MaintenancePolicyParams, QuakeIndex, SearchParams
from quake_tpu_torch import coordinator as tc
from quake_tpu_torch.ops.scan import flat_scan
from quake_tpu_torch.parallel import mesh as tmesh
from quake_tpu_torch.parallel import sharded as tsharded
from quake_tpu_torch.utils import compute_recall, knn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDEV = 8
IVF = SearchParams(k=10, nprobe=8)
APS = dict(k=10, recall_target=0.9, initial_search_fraction=0.5)

pytestmark = pytest.mark.skipif(len(jax.devices()) < NDEV,
                                reason="needs the 8 virtual CPU devices of conftest.py")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Many small torch ops (the APS host loop over 8 shards): two threads
    keep them from spinning against the other test processes' threads;
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _overlap(a, b):
    """Mean over rows of the share of b's ids (>= 0) that a holds."""
    tot = 0.0
    for x, y in zip(a, b):
        sx, sy = {v for v in x.tolist() if v >= 0}, {v for v in y.tolist() if v >= 0}
        tot += len(sx & sy) / len(sy) if sy else float(not sx)
    return tot / len(b)


def _jax_sp(sp: SearchParams) -> JaxSearchParams:
    return JaxSearchParams(**{f: getattr(sp, f) for f in (
        "k", "nprobe", "recall_target", "initial_search_fraction", "aps_mode",
        "exact_distances", "batched_scan")})


def _saved(tmp_path_factory, name, x, bp):
    """A JAX index of x built with bp and saved; the path."""
    path = str(tmp_path_factory.mktemp(name))
    idx = JaxIndex()
    idx.build(x, np.arange(len(x), dtype=np.int64), bp)
    idx.save(path)
    return path


@pytest.fixture(scope="module")
def ivf32(small_data, tmp_path_factory):
    """The JAX test's index (small_data, nlist 32, calibrated), saved."""
    x, _, _ = small_data
    return _saved(tmp_path_factory, "ivf32", x, JaxBuildParams(nlist=32))


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """The oneshot test's clustered corpus (seed 3) and queries, indexed
    by the JAX package and saved."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 6.0
    assign = rng.integers(0, 32, 10_000)
    x = centers[assign] + rng.standard_normal((10_000, 32)).astype(np.float32)
    q = centers[rng.integers(0, 32, 64)] + rng.standard_normal((64, 32)).astype(np.float32)
    return _saved(tmp_path_factory, "clustered", x, JaxBuildParams(nlist=32)), q


def _pair(path, monkeypatch, kernel="xla"):
    """The saved index loaded by each package (the kernel pinned in both),
    both sharded 8 ways: (JAX index, port index)."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", kernel)
    j = JaxIndex().load(path)
    j.shard(NDEV)
    t = QuakeIndex(device="cpu").load(path)
    t.shard(NDEV)
    return j, t


def _hold(j, t, q, sp, tol=1e-5):
    """The port's sharded search equal to the JAX package's (ids,
    distances within tol, partitions_scanned). Returns the port's result."""
    rj, rt = j.search(q, _jax_sp(sp)), t.search(q, sp)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=tol, atol=tol)
    assert rt.timing_info.partitions_scanned == rj.timing_info.partitions_scanned
    return rt


def _v11_overlap(path, q, sp, monkeypatch):
    """Under the port's default scan (v11): the sharded ids overlap the
    unsharded ones at >= 0.99. Where they do not, the unsharded keys are the
    cause and the shards' finer ones (levels follow C) the cure: then the
    sharded ids overlap the exact scan's ("xla", unsharded) at >= 0.99 and
    at least as well as the unsharded ids do."""
    monkeypatch.delenv("QUAKE_TPU_KERNEL", raising=False)
    t = QuakeIndex(device="cpu").load(path)
    plain = t.search(q, sp)
    t.shard(NDEV)
    sharded = t.search(q, sp)
    if _overlap(sharded.ids, plain.ids) < 0.99:
        monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
        exact = QuakeIndex(device="cpu").load(path).search(q, sp).ids
        monkeypatch.delenv("QUAKE_TPU_KERNEL")
        assert _overlap(sharded.ids, exact) >= max(0.99, _overlap(plain.ids, exact))
    return plain, sharded


def _shards_equal_primary(idx, n=NDEV):
    """Each of the n slot shards contiguous and equal to the primary's
    slice."""
    st, sh = idx.store.state, idx._shards()
    Cl = idx.store.C // n
    assert sh.strategy == "slot" and len(sh.codes) == n
    for s in range(n):
        sl = slice(s * Cl, (s + 1) * Cl)
        for name in ("codes", "ids", "norms"):
            part = getattr(sh, name)[s]
            assert part.is_contiguous()
            assert torch.equal(part, getattr(st, name)[:, sl]), (name, s)
        assert torch.equal(sh.local_sizes[s], (st.ids[:, sl] >= 0).sum(1).to(torch.int32))


# ------------------------------------------------------------ the 13 cases


def test_sharded_ivf_matches_single_device(small_data, ivf32, monkeypatch):
    _, _, q = small_data
    j, t = _pair(ivf32, monkeypatch)
    _hold(j, t, q, IVF)
    plain = QuakeIndex(device="cpu").load(ivf32).search(q, IVF)
    np.testing.assert_array_equal(t.search(q, IVF).ids, plain.ids)
    _v11_overlap(ivf32, q, IVF, monkeypatch)


def test_sharded_flat_matches_single_device(small_data, tmp_path_factory, monkeypatch):
    x, _, q = small_data
    path = _saved(tmp_path_factory, "flat", x[:4096], JaxBuildParams(nlist=0))
    j, t = _pair(path, monkeypatch)
    sp = SearchParams(k=10)
    res = _hold(j, t, q, sp)
    plain = QuakeIndex(device="cpu").load(path).search(q, sp)
    np.testing.assert_array_equal(res.ids, plain.ids)


def test_sharded_partition_strategy_matches(small_data, ivf32):
    _, _, q = small_data
    jst = JaxIndex().load(ivf32).store.state
    t = QuakeIndex(device="cpu").load(ivf32)
    pids = np.tile(np.arange(32, dtype=np.int32), (len(q), 1))
    jmesh = jax_make_mesh()
    jsh = jax_shard_store_state(jst, jmesh, strategy="partition")
    js, ji, jn = jax_sharded_ivf_search(jmesh, jsh.codes, jsh.ids, jnp.asarray(q),
                                         jnp.asarray(pids), 10, "l2", strategy="partition")
    sh = tmesh.shard_store_state(t.store.state, tmesh.make_mesh(NDEV, device="cpu"),
                                 strategy="partition")
    qt, pt = torch.from_numpy(q), torch.from_numpy(pids)
    ts, ti, tn = tsharded.sharded_ivf_search(sh, qt, pt, 10, "l2")
    s0, i0, _ = tc.ivf_search(t.store.state.codes, t.store.state.ids, qt, pt, 10, "l2")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), i0.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    assert (tn.numpy() == 32).all() and (np.asarray(jn) == 32).all()


@pytest.mark.parametrize("mode", ["auto", "planned"])
def test_sharded_aps_matches_single_device(small_data, ivf32, monkeypatch, mode):
    """test_sharded_aps_matches_single_device (auto) and
    test_sharded_aps_planned_matches_single_device (planned)."""
    _, _, q = small_data
    sp = SearchParams(**APS, aps_mode=mode)
    j, t = _pair(ivf32, monkeypatch)
    res = _hold(j, t, q, sp)
    plain = QuakeIndex(device="cpu").load(ivf32).search(q, sp)
    np.testing.assert_array_equal(res.ids, plain.ids)
    assert res.timing_info.partitions_scanned == plain.timing_info.partitions_scanned
    _v11_overlap(ivf32, q, sp, monkeypatch)


def test_sharded_aps_oneshot_matches_single_device(clustered, monkeypatch):
    path, q = clustered
    j, t = _pair(path, monkeypatch)
    if t.aps_radius_ab is None:
        pytest.skip("radius predictor declined calibration on this corpus")
    sp = SearchParams(**APS, aps_mode="oneshot")
    res = _hold(j, t, q, sp, tol=1e-4)
    plain = QuakeIndex(device="cpu").load(path).search(q, sp)
    np.testing.assert_array_equal(res.ids, plain.ids)
    assert res.timing_info.partitions_scanned == plain.timing_info.partitions_scanned
    _v11_overlap(path, q, sp, monkeypatch)


def test_sharded_aps_partition_strategy(small_data, ivf32):
    _, _, q = small_data
    jidx = JaxIndex().load(ivf32)
    jst = jidx.store.state
    t = QuakeIndex(device="cpu").load(ivf32)
    dim = t.aps_dimension or t.d()
    qd = jnp.asarray(q)
    _, jp = jax_flat_scan(qd, jst.centroids,
                          jnp.arange(jst.centroids.shape[0], dtype=jnp.int32), 16, "l2")
    jmesh = jax_make_mesh()
    jsh = jax_shard_store_state(jst, jmesh, strategy="partition")
    _, ji, jn = jax_sharded_aps_search(jmesh, jsh.codes, jsh.ids, jst.centroids, qd, jp,
                                       jnp.float32(0.9), jnp.float32(0.0), k=10, metric="l2",
                                       dimension=dim, strategy="partition")
    _, ji0, jn0 = jax_aps_search(jst.codes, jst.ids, jst.centroids, qd, jp, jnp.float32(0.9),
                                 jnp.float32(0.0), k=10, metric="l2", dimension=dim)
    st = t.store.state
    qt = torch.from_numpy(q)
    _, tp = flat_scan(qt, st.centroids, torch.arange(st.centroids.shape[0], dtype=torch.int32),
                      16, "l2")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    sh = tmesh.shard_store_state(st, tmesh.make_mesh(NDEV, device="cpu"), strategy="partition")
    _, ti, tn = tsharded.sharded_aps_search(sh, qt, tp, 0.9, 0.0, k=10, metric="l2",
                                            dimension=dim)
    _, ti0, tn0 = tc.aps_search(st.codes, st.ids, st.centroids, qt, tp, 0.9, 0.0, k=10,
                                metric="l2", dimension=dim)
    np.testing.assert_array_equal(np.asarray(ji0), np.asarray(ji))  # the JAX test
    np.testing.assert_array_equal(np.asarray(jn0), np.asarray(jn))
    np.testing.assert_array_equal(ti.numpy(), ti0.numpy())
    np.testing.assert_array_equal(tn.numpy(), tn0.numpy())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_sharded_mutation_after_sharding(small_data, tmp_path_factory, monkeypatch):
    """add / remove through a sharded index: the JAX package's gate on the
    port's own num_shards build, then both packages on one JAX-built
    store, the arrays equal after each write, the shards rebuilt equal to
    the primary's slices, and the searches equal."""
    x, ids, q = small_data
    keep = np.concatenate([ids[500:5000], ids[5000:6000]])
    gt_ids, _ = knn(q, x[keep], 10, "l2", ids=keep)
    own = QuakeIndex(device="cpu")
    own.build(x[:5000], ids[:5000], IndexBuildParams(nlist=16, num_shards=NDEV))
    assert own.mesh.size == NDEV and own.store.C % (128 * NDEV) == 0
    own.add(x[5000:6000], ids[5000:6000])
    own.remove(ids[:500])
    assert own.ntotal() == 5500
    res = own.search(q, SearchParams(k=10, nprobe=16))
    assert compute_recall(res.ids, gt_ids, 10) >= 0.99
    _shards_equal_primary(own)

    path = _saved(tmp_path_factory, "mut", x[:5000],
                  JaxBuildParams(nlist=16, num_shards=NDEV))
    j, t = _pair(path, monkeypatch)
    sp = SearchParams(k=10, nprobe=16)
    for step in (lambda i: i.add(x[5000:6000], ids[5000:6000]), lambda i: i.remove(ids[:500])):
        step(j)
        step(t)
        for name in ("codes", "ids", "sizes", "centroids", "active"):
            np.testing.assert_array_equal(getattr(t.store.state, name).numpy(),
                                          np.asarray(getattr(j.store.state, name)))
        _shards_equal_primary(t)
        _hold(j, t, q, sp)
    assert t.ntotal() == 5500 and t.validate()


def test_sharded_kmeans_step_matches_replicated():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 16)).astype(np.float32)
    cents = x[:8].copy()
    from jax.sharding import NamedSharding, PartitionSpec as P

    jmesh = jax_make_mesh()
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("shard")))
    jc = jax.device_put(jnp.asarray(cents), NamedSharding(jmesh, P()))
    jnew, ja = jax_sharded_kmeans_step(jmesh, jx, jc)
    mesh = tmesh.make_mesh(NDEV, device="cpu")
    blocks = [b.to(d) for b, d in zip(torch.from_numpy(x).chunk(NDEV), mesh.devices)]
    tnew, ta = tsharded.sharded_kmeans_step(mesh, blocks, torch.from_numpy(cents))
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(torch.cat(ta).numpy(), np.asarray(ja))
    d2 = (x ** 2).sum(1)[:, None] - 2 * x @ cents.T + (cents ** 2).sum(1)[None, :]
    a = np.argmin(d2, axis=1)
    expected = np.stack([x[a == c].mean(0) if (a == c).any() else cents[c] for c in range(8)])
    np.testing.assert_allclose(tnew.numpy(), expected, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(torch.cat(ta).numpy(), a)


def test_sharded_maintenance_and_validate(small_data, monkeypatch):
    """The JAX test on each package's own num_shards build from the same
    data; the port's shards after maintenance equal the primary's slices,
    and its sharded search (xla) equals the same store searched unsharded."""
    x, ids, q = small_data
    gt_ids, _ = knn(q, x, 10, "l2")
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            idx = JaxIndex()
            idx.build(x, ids, JaxBuildParams(nlist=16, num_shards=NDEV))
            params = JaxMaintParams
        else:
            idx = QuakeIndex(device="cpu")
            idx.build(x, ids, IndexBuildParams(nlist=16, num_shards=NDEV))
            params = MaintenancePolicyParams
        idx.initialize_maintenance_policy(params(window_size=20, split_threshold_ns=0.0,
                                                 refinement_radius=4))
        for _ in range(25):
            idx.maintenance_policy.record_query_hits([0, 1])
        ntotal = idx.ntotal()
        idx.maintenance()
        assert idx.ntotal() == ntotal
        assert idx.validate()
        sp = SearchParams(k=10, nprobe=idx.nlist())
        res = idx.search(q, _jax_sp(sp) if pkg == "jax" else sp)
        assert compute_recall(res.ids, gt_ids, 10) >= 0.99
    _shards_equal_primary(idx)
    mesh = idx.mesh
    idx.mesh = None
    plain = idx.search(q, sp)
    idx.mesh = mesh
    np.testing.assert_array_equal(res.ids, plain.ids)


def test_sharded_fused_parent_sharding_parity(small_data, tmp_path_factory, monkeypatch):
    """sharded_fused_search with the parents ranked per shard and merged
    equals the replicated parent ranking and the single-device search; the
    probe sets equal; the port's ids equal the JAX package's."""
    from quake_tpu.parallel.sharded import sharded_fused_search as jax_fused

    x, _, q = small_data
    path = _saved(tmp_path_factory, "nl128", x, JaxBuildParams(nlist=128, calibrate_aps=False))
    j, t = _pair(path, monkeypatch)
    single = QuakeIndex(device="cpu").load(path).search(q, IVF)
    sh, pst = t._shards(), t.parent.store.state
    N = pst.codes.shape[0] * pst.codes.shape[1]
    assert N % NDEV == 0 and N // NDEV >= 8, N
    out = {}
    for sp in (True, False):
        s, i, d, scanned, probe = tsharded.sharded_fused_search(
            sh, pst.codes, pst.ids, torch.from_numpy(q), k=10, nprobe=8, metric="l2", qt=8,
            group_chunk=16, shard_parents=sp)
        out[sp] = (i.numpy(), d.numpy(), probe.numpy())
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-5, atol=1e-5)
    for b in range(len(q)):
        assert set(out[True][2][b].tolist()) == set(out[False][2][b].tolist())
    np.testing.assert_array_equal(out[True][0], single.ids)
    jst, jpst = j.store.state, j.parent.store.state
    _, ji, jd, _, _ = jax_fused(j.mesh, jst.codes, jst.ids, jst.norms, jpst.codes, jpst.ids,
                                jnp.asarray(q), k=10, nprobe=8, metric="l2", qt=8,
                                group_chunk=16)
    np.testing.assert_array_equal(out[True][0], np.asarray(ji))
    np.testing.assert_allclose(out[True][1], np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["loop", "planned"])
def test_sharded_aps_dequantized_matches_single_device(small_data, ivf32, monkeypatch, mode):
    _, _, q = small_data
    sp = SearchParams(**APS, aps_mode=mode, exact_distances=False)
    j, t = _pair(ivf32, monkeypatch)
    res = _hold(j, t, q, sp)
    plain = QuakeIndex(device="cpu").load(ivf32).search(q, sp)
    np.testing.assert_array_equal(res.ids, plain.ids)
    _v11_overlap(ivf32, q, sp, monkeypatch)


def test_shard_rebuckets_capacity_to_local_tile_multiple(small_data, ivf32, monkeypatch):
    """shard() re-buckets C to a multiple of 128 * ndev (the JAX package's
    C after its shard()), so each shard's slice is a 128 multiple; results
    unchanged; growth keeps the multiple."""
    _, _, q = small_data
    j, t = _pair(ivf32, monkeypatch)
    assert t.store.C == j.store.C and t.store.C % (128 * NDEV) == 0
    assert all(c.shape[1] % 128 == 0 for c in t._shards().codes)
    before = _hold(j, t, q, IVF)
    st = t.store
    old_c = st.C
    counts = np.zeros(st.P, dtype=np.int64)
    counts[0] = old_c + 1
    st.ensure_capacity(counts)
    assert st.C > old_c and st.C % (128 * NDEV) == 0
    _shards_equal_primary(t)
    np.testing.assert_array_equal(t.search(q, IVF).ids, before.ids)


# ------------------------------------------------------------ the mesh


def test_make_mesh(monkeypatch):
    """Truncation to the CUDA devices there are (jax.devices()[:n]),
    explicit and repeated devices, virtual CPU shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = tmesh.make_mesh(4, device="cuda")
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_mesh(0, device="cuda").size == 2
    assert tmesh.make_mesh(1, device="cuda").devices == (torch.device("cuda", 0),)
    rep = tmesh.make_mesh(devices=["cuda:0"] * 4)
    assert rep.size == 4 and rep.first == torch.device("cuda", 0)
    assert tmesh.make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    assert tmesh.make_mesh(device="cpu").size == 1
    assert tmesh.make_mesh(devices=["cpu", "cpu"]).axis == tmesh.SHARD_AXIS == "shard"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2, device="cuda")


def test_shard_store_state_divisibility_and_layout(ivf32):
    """The JAX package's ValueErrors where the axis does not divide; slot
    shards contiguous copies, partition shards slices; replicated
    centroids, active and (slot) sizes."""
    t = QuakeIndex(device="cpu").load(ivf32)
    st = t.store.state
    P, C = st.ids.shape
    with pytest.raises(ValueError, match=f"partition axis {P} not divisible by 3"):
        tmesh.shard_store_state(st, tmesh.make_mesh(3, device="cpu"), strategy="partition")
    with pytest.raises(ValueError, match=f"slot axis {C} not divisible by 5"):
        tmesh.shard_store_state(st, tmesh.make_mesh(5, device="cpu"))
    with pytest.raises(ValueError, match="strategy"):
        tmesh.shard_store_state(st, tmesh.make_mesh(2, device="cpu"), strategy="rows")
    mesh = tmesh.make_mesh(2, device="cpu")
    slot = tmesh.shard_store_state(st, mesh)
    part = tmesh.shard_store_state(st, mesh, strategy="partition")
    for s in range(2):
        assert slot.codes[s].is_contiguous()
        assert slot.codes[s].shape == (P, C // 2, st.codes.shape[2])
        assert slot.codes[s].data_ptr() != st.codes.data_ptr()
        assert part.codes[s].shape == (P // 2, C, st.codes.shape[2])
        assert torch.equal(part.sizes[s], st.sizes[s * P // 2:(s + 1) * P // 2])
        assert slot.sizes[s] is st.sizes and slot.centroids[s] is st.centroids
        assert slot.active[s] is st.active
    assert part.codes[1].data_ptr() == st.codes[P // 2].data_ptr()  # a view, no copy
    with pytest.raises(ValueError, match="cannot shard onto"):
        t.shard(2, devices=["cpu", "meta"])


def test_index_shards_rebuilt_after_writes(small_data, ivf32):
    """PartitionStore.version moves on every write, and the index rebuilds
    its shards from the primary after it; searches do not rebuild them."""
    x, _, q = small_data
    t = QuakeIndex(device="cpu").load(ivf32)
    t.shard(4)
    before = t._shards()
    t.search(q, IVF)
    assert t._shards() is before
    v = t.store.version
    t.add(x[:3] + 100.0, np.arange(20_000, 20_003))
    assert t.store.version > v and t._shards() is not before
    _shards_equal_primary(t, 4)
    t.modify(np.arange(20_000, 20_003), x[:3])
    _shards_equal_primary(t, 4)
    t.remove(np.arange(20_000, 20_003))
    _shards_equal_primary(t, 4)
    assert t.validate()


def test_parallel_imports_without_jax():
    """No module under quake_tpu_torch/parallel/ imports jax or quake_tpu."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import quake_tpu_torch.parallel, quake_tpu_torch.parallel.mesh
        import quake_tpu_torch.parallel.sharded
        bad = [m for m in sys.modules if m == "quake_tpu" or m.startswith("quake_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pkg = os.path.join(REPO, "quake_tpu_torch", "parallel")
    for name in os.listdir(pkg):
        if name.endswith(".py"):
            src = open(os.path.join(pkg, name)).read()
            assert "import jax" not in src and "from jax" not in src, name
            assert "from quake_tpu." not in src and "import quake_tpu\n" not in src, name


def test_wrapper_num_shards_passes_through(small_data, monkeypatch):
    """QuakeWrapper.build(num_shards=) reaches the build's shard plan (the
    wrapper adds nothing): a CPU index on two virtual shards, searching
    as the unsharded wrapper's index does under "xla"."""
    from quake_tpu_torch.wrappers.quake import QuakeWrapper

    x, _, q = small_data
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    sharded, plain = QuakeWrapper(device="cpu"), QuakeWrapper(device="cpu")
    sharded.build(x[:3000], nc=8, num_shards=2)
    plain.build(x[:3000], nc=8)
    assert sharded.index.mesh.size == 2 and plain.index.mesh is None
    np.testing.assert_array_equal(sharded.search(q, k=10, nprobe=3).ids,
                                  plain.search(q, k=10, nprobe=3).ids)
