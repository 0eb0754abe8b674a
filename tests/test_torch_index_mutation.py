"""QuakeIndex mutation in the port against the JAX package, on the CPU.

The JAX package builds an index; `index_from_numpy` carries its store and
its parent's, with the free-row order, the generation counters and the
capacity rounding, into the port; then the same adds, buffered adds,
removes, modifies, gets, splits and floods run through both indexes. After
every step the six store arrays of both levels agree (placed by integer
arithmetic: equal; the cached norms are f32 sums in another order: rtol
1e-6, as in test_torch_store.py), and so do the free rows, the generations,
nlist, ntotal and the sorted ids; validate() holds and so does ROADMAP Queue
3 contract 6 (compact prefix and norms). The splits are host k-means
(`kmeans_np`, the same numpy code in both packages), so their partitions
agree exactly. Search after a flood is held to the JAX package's parent
ranking (kernel K3's Pallas body) and v11 scan in interpret mode by id
overlap >= 0.99, as in test_torch_index.py. The port-only cases mirror
tests/test_index.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu.ops.pallas_grouped import grouped_scan_pallas_v11
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy
from quake_tpu_torch.convert import FIELDS
from quake_tpu_torch.ops.grouped_family import grouped_scan_v3p, grouped_scan_v8
from quake_tpu_torch.utils import compute_recall, knn
from test_torch_store_mutation import _assert_same, _contract_6

N0, D = 5000, 16


def _data(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


@pytest.fixture(scope="module")
def saved_jax(tmp_path_factory):
    """A JAX index over N0 vectors, saved once: each test loads a fresh one."""
    idx = JaxIndex()
    idx.build(_data(N0, 1), np.arange(N0), JaxBuildParams(nlist=16, niter=5, calibrate_aps=False))
    path = str(tmp_path_factory.mktemp("jax") / "idx")
    idx.save(path)
    return path


def carry_store(store) -> dict:
    """A JAX store's arrays and host bookkeeping, for index_from_numpy."""
    out = {f: np.asarray(getattr(store.state, f)) for f in FIELDS}
    out.update(free_rows=list(store.free_rows), generation=store.generation.copy(),
               cap_multiple=store.cap_multiple)
    return out


def carry(jidx) -> QuakeIndex:
    bp = IndexBuildParams(nlist=jidx.build_params.nlist, metric=jidx.metric,
                          mutation_buffer_size=jidx.build_params.mutation_buffer_size)
    parent = carry_store(jidx.parent.store) if jidx.parent is not None else None
    return index_from_numpy(carry_store(jidx.store), parent, jidx.metric, device="cpu",
                            build_params=bp)


def _pair(saved, buffer=0):
    jidx = JaxIndex().load(saved)
    jidx.build_params.mutation_buffer_size = buffer
    tidx = carry(jidx)
    assert_same_index(jidx, tidx)
    return jidx, tidx


def assert_same_index(jidx, tidx):
    """Both levels' arrays and bookkeeping, the index's counts and ids,
    validate() and contract 6 (the JAX index first: both flush)."""
    assert jidx.validate() and tidx.validate()
    for js, ts in ((jidx.store, tidx.store), (jidx.parent.store, tidx.parent.store)):
        _assert_same(js, ts)
        _contract_6(ts)
    assert (tidx.nlist(), tidx.ntotal(), tidx.parent.ntotal()) == (
        jidx.nlist(), jidx.ntotal(), jidx.parent.ntotal())
    np.testing.assert_array_equal(np.sort(tidx.get_ids()), np.sort(jidx.get_ids()))


def apply(jidx, tidx, method, *args):
    """The same call on both indexes, then the whole comparison."""
    a, b = getattr(jidx, method)(*args), getattr(tidx, method)(*args)
    assert_same_index(jidx, tidx)
    return a, b


def jax_v11_ids(jidx, tidx, q, k, nprobe):
    """The JAX main path from its own kernels in interpret mode: the Pallas
    parent ranking (K3's body) and the v11 scan at the port's qt and gpb."""
    st, pst = jidx.store.state, jidx.parent.store.state
    qj = jnp.asarray(q)
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, qj, nprobe, "l2", interpret=True)
    pids = jnp.where(pids >= 0, pids, pids[:, :1])
    gpb = int(tidx._grouped_kernel()[len("v11g"):])
    _, ids, _ = grouped_scan_pallas_v11(st.codes, st.ids, st.sizes, st.norms, qj, pids, k, "l2",
                                        qt=tidx._grouped_params(len(q), nprobe)[0], gpb=gpb,
                                        interpret=True)
    return np.asarray(ids)


def overlap(a, b, k):
    return np.mean([len(set(u) & set(v)) / k for u, v in zip(a, b)])


def test_mutation_sequence_matches_jax(saved_jax, monkeypatch):
    """Adds, removes (some ids absent), modify, get, then a flood of tight
    copies of one vector that overflows its partition: both indexes split it
    into the same partitions (C unchanged, a freed row reused with its
    generation moved on), and search agrees with the JAX kernels."""
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    jidx, tidx = _pair(saved_jax)
    x = _data(2000, 2)
    apply(jidx, tidx, "add", x[:1200], np.arange(10_000, 11_200))
    apply(jidx, tidx, "add", x[1200], np.array([11_200]))  # one vector, 1-D
    apply(jidx, tidx, "remove", np.concatenate([np.arange(0, 600), np.arange(10_500, 10_700),
                                                np.array([77_777])]))
    new = _data(20, 3)
    apply(jidx, tidx, "modify", np.arange(1000, 1020), new)
    a, b = apply(jidx, tidx, "get", np.arange(1000, 1020))
    np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(b, new)

    C0, nlist0, P0 = tidx.store.C, tidx.nlist(), tidx.store.P
    free0 = list(tidx.store.free_rows)
    rng = np.random.default_rng(3)
    n_flood = int(C0 * 2.5)
    flood = x[0] + 0.001 * rng.standard_normal((n_flood, D)).astype(np.float32)
    target = int(tidx._assign_rows(flood[:1])[0])
    gen0 = int(tidx.store.generation[target])
    apply(jidx, tidx, "add", flood, np.arange(100_000, 100_000 + n_flood))
    assert tidx.store.C == C0 and tidx.store.P == P0
    assert tidx.nlist() > nlist0 + 1
    # The split row was freed and taken again first, with its generation
    # moved on by the delete and the allocation.
    assert target not in tidx.store.free_rows
    assert int(tidx.store.generation[target]) == gen0 + 2
    assert len(tidx.store.free_rows) == len(free0) - (tidx.nlist() - nlist0)
    # The flooded region is still findable.
    res = tidx.search(flood[:16], SearchParams(k=1, nprobe=tidx.nlist()))
    assert (res.ids[:, 0] >= 100_000).all()

    q = _data(64, 4)
    k, nprobe = 10, 6
    got = tidx.search(q, SearchParams(k=k, nprobe=nprobe)).ids
    assert overlap(jax_v11_ids(jidx, tidx, q, k, nprobe), got, k) >= 0.99


def test_buffered_adds_match_jax(saved_jax):
    """mutation_buffer_size: small adds wait in the buffer (counted by
    ntotal, seen by the duplicate check), flush at a full buffer or at any
    read, and leave the same store as in the JAX package."""
    jidx, tidx = _pair(saved_jax, buffer=1000)
    x = _data(1500, 5)
    for i in range(0, 900, 100):
        jidx.add(x[i:i + 100], np.arange(20_000 + i, 20_100 + i))
        tidx.add(x[i:i + 100], np.arange(20_000 + i, 20_100 + i))
    assert len(tidx._pending_vids) == 9 and tidx.store.ntotal() == N0
    assert tidx.ntotal() == jidx.ntotal() == N0 + 900
    for index in (jidx, tidx):
        with pytest.raises(ValueError, match="pending"):
            index.add(x[:1], np.array([20_050]))
    # The tenth add fills the buffer and flushes it.
    apply(jidx, tidx, "add", x[900:1000], np.arange(20_900, 21_000))
    assert not tidx._pending_vids and tidx.store.ntotal() == N0 + 1000
    jidx.add(x[1000:1200], np.arange(21_000, 21_200))
    tidx.add(x[1000:1200], np.arange(21_000, 21_200))
    apply(jidx, tidx, "remove", np.arange(21_100, 21_150))  # flushes first
    assert tidx.ntotal() == N0 + 1150


def test_split_partitions_matches_jax(saved_jax, monkeypatch):
    """split_partitions on the host path (the JAX package's with
    QUAKE_TPU_MAINT_HOST=1): the same halves into the same rows."""
    monkeypatch.setenv("QUAKE_TPU_MAINT_HOST", "1")
    jidx, tidx = _pair(saved_jax)
    rows = [int(r) for r in tidx.store.active_rows()[[2, 5, 11]]]
    want, got = apply(jidx, tidx, "split_partitions", rows)
    assert got == want and len(got) == 6
    assert tidx.nlist() == 16 + 3
    assert tidx.split_partitions([]) == []


def test_id_validation_matches_jax(saved_jax):
    """Duplicate, negative, out-of-range, resident and pending-duplicate ids
    raise ValueError in both packages, and a missing id in get raises
    KeyError; none of them changes either index."""
    jidx, tidx = _pair(saved_jax, buffer=4096)
    x = _data(4, 6)
    jidx.add(x[:1], np.array([30_000]))
    tidx.add(x[:1], np.array([30_000]))
    bad = [(x[:2], np.array([200_000, 200_000]), "duplicate"),
           (x[:1], np.array([-3]), "non-negative"),
           (x[:1], np.array([2 ** 31 - 1]), "INT32_MAX"),
           (x[:2], np.array([300_000, 7]), "already in index"),
           (x[:1], np.array([30_000]), "pending")]
    for vecs, ids, match in bad:
        for index in (jidx, tidx):
            with pytest.raises(ValueError, match=match):
                index.add(vecs, ids)
    for index in (jidx, tidx):
        with pytest.raises(KeyError):
            index.get(np.array([7, 999_999]))
    assert_same_index(jidx, tidx)
    assert tidx.ntotal() == N0 + 1


def test_carried_free_rows_and_generation():
    """ROADMAP Queue 3 fault 9: after delete_partitions([3]), then
    delete_partitions([7]) on the JAX store, the carried store takes rows 7
    and 3 in that order, as the JAX store does, and both rows reach
    generation 2 in both. Without the bookkeeping the carry keeps the old
    rule (free rows highest first, generations 0)."""
    from quake_tpu.storage.store import PartitionStore as JaxStore
    from quake_tpu_torch.convert import store_from_numpy

    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    cents = rng.standard_normal((10, 8)).astype(np.float32)
    assign = rng.integers(0, 10, 300).astype(np.int32)
    js = JaxStore(8)
    js.init_from_assignments(x, np.arange(300), cents, assign)
    js.delete_partitions([3])
    js.delete_partitions([7])
    ts = store_from_numpy(carry_store(js), "cpu")
    _assert_same(js, ts)
    assert ts.allocate_rows(2) == js.allocate_rows(2) == [7, 3]
    assert ts.generation[3] == js.generation[3] == 2 and ts.generation[7] == 2
    _assert_same(js, ts)

    plain = {f: np.asarray(getattr(js.state, f)) for f in FIELDS}
    old = store_from_numpy(plain, "cpu")
    assert old.allocate_rows(2) == [3, 7] and old.cap_multiple == 128
    assert list(old.generation[[3, 7]]) == [1, 1]


def test_parent_growth_past_256_centroids():
    """Splits that take the parent past its 256 slots grow the parent's C
    (K3's N changes): the grown tensors are contiguous (contract 7), the
    index validates, contract 6 holds on both levels, and a full-probe
    search finds every vector (away from the flood, whose copies lie closer
    to x[0] than f32 scores resolve)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6000, 8)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=240, niter=3, calibrate_aps=False))
    assert idx.parent.store.C == 256 and idx.store.C == 256
    flood = x[0] + 1e-4 * rng.standard_normal((192 * 20, 8)).astype(np.float32)
    idx.add(flood, np.arange(50_000, 50_000 + len(flood)))
    assert idx.nlist() > 256 and idx.store.C == 256
    assert idx.parent.store.C == 512 and idx.parent.ntotal() == idx.nlist()
    assert idx.parent.store.state.codes.is_contiguous()
    assert idx.validate()
    _contract_6(idx.store)
    _contract_6(idx.parent.store)
    res = idx.search(x[1:33], SearchParams(k=1, nprobe=idx.nlist()))
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(1, 33))


def test_growth_past_ref_packing_through_add():
    """ROADMAP Queue 3 contract 3 through the index: uniform adds (no
    partition an outlier, so no split) grow C past 65536; the scans that pack
    (pid << 16) | slot then raise, the default search among them."""
    rng = np.random.default_rng(9)
    idx = QuakeIndex(device="cpu")
    idx.build(rng.standard_normal((512, 4)).astype(np.float32), None,
              IndexBuildParams(nlist=2, niter=3, calibrate_aps=False))
    n = 140_000
    idx.add(rng.standard_normal((n, 4)).astype(np.float32), np.arange(1000, 1000 + n))
    assert idx.store.C > 65536 and idx.nlist() == 2 and idx.validate()
    st = idx.store.state
    q = rng.standard_normal((16, 4)).astype(np.float32)
    pids = torch.zeros((16, 2), dtype=torch.int32)
    for scan in (grouped_scan_v3p, grouped_scan_v8):
        with pytest.raises(ValueError, match=r"packs \(pid, slot\) into int32"):
            scan(st.codes, st.ids, st.sizes, st.norms, torch.from_numpy(q), pids, 5, "l2")
    with pytest.raises(ValueError, match=r"packs \(pid, slot\) into int32"):
        idx.search(q, SearchParams(k=5, nprobe=2))


def test_spilled_index_refuses_mutation():
    """Lifted (the name kept as it was): a spilled JAX index carried across
    with both id maps takes an add, a remove and a modify as the JAX index
    does, both copies of each vector placed, removed and rewritten, both
    levels' arrays and both maps equal after each (test_torch_spill.py
    covers the rest)."""
    from test_torch_spill import apply as apply_spilled
    from test_torch_spill import carry as carry_spilled

    jidx = JaxIndex()
    jidx.build(_data(2000, 8), np.arange(2000), JaxBuildParams(nlist=8, spill=True))
    tidx = carry_spilled(jidx)
    apply_spilled(jidx, tidx, "add", _data(50, 7), np.arange(40_000, 40_050))
    apply_spilled(jidx, tidx, "remove", np.arange(0, 2000, 7))
    apply_spilled(jidx, tidx, "modify", np.arange(40_000, 40_010), _data(10, 9))
    assert tidx.ntotal() == 2050 - len(range(0, 2000, 7))


# --------------------------------------------------- port-only (test_index.py)


@pytest.fixture(scope="module")
def small():
    x = np.random.default_rng(1).standard_normal((10_000, 32)).astype(np.float32)
    q = np.random.default_rng(2).standard_normal((100, 32)).astype(np.float32)
    return x, np.arange(10_000, dtype=np.int64), q


def _build(x, ids, nlist, **kw):
    idx = QuakeIndex(device="cpu")
    idx.build(x, ids, IndexBuildParams(nlist=nlist, niter=5, calibrate_aps=False, **kw))
    return idx


def test_add_remove_roundtrip(small):
    x, ids, q = small
    idx = _build(x[:5000], ids[:5000], 32)
    idx.add(x[5000:], ids[5000:])
    assert idx.ntotal() == 10_000
    gt, _ = knn(q, x, 10, "l2")
    assert compute_recall(idx.search(q, SearchParams(k=10, nprobe=32)).ids, gt, 10) >= 0.99
    idx.remove(ids[5000:])
    assert idx.ntotal() == 5000
    gt, _ = knn(q, x[:5000], 10, "l2", ids=ids[:5000])
    assert compute_recall(idx.search(q, SearchParams(k=10, nprobe=32)).ids, gt, 10) >= 0.99
    assert idx.validate()


def test_mutation_buffer_semantics(small):
    x, ids, q = small
    idx = _build(x[:5000], ids[:5000], 16, mutation_buffer_size=2048)
    for i in range(5000, 6000, 100):
        idx.add(x[i:i + 100], ids[i:i + 100])
    assert idx.ntotal() == 6000
    with pytest.raises(ValueError):
        idx.add(x[5000:5001], ids[5000:5001])
    res = idx.search(q, SearchParams(k=10, nprobe=16))  # flushes
    assert len(idx._pending_vids) == 0
    gt, _ = knn(q, x[:6000], 10, "l2")
    assert compute_recall(res.ids, gt, 10) >= 0.99
    idx.remove(ids[:100])
    assert idx.ntotal() == 5900
    assert idx.validate()


def test_add_duplicate_ids_rejected(small):
    x, ids, _ = small
    idx = _build(x[:100], ids[:100], 4)
    for vecs, bad in ((x[:5], ids[:5]), (x[:2], np.array([200, 200])), (x[:1], np.array([-3]))):
        with pytest.raises(ValueError):
            idx.add(vecs, bad)


def test_get_and_get_ids(small):
    x, ids, _ = small
    idx = _build(x[:500], ids[:500], 8)
    np.testing.assert_allclose(idx.get(ids[10:20]), x[10:20], rtol=1e-6)
    assert set(idx.get_ids().tolist()) == set(ids[:500].tolist())
    with pytest.raises(KeyError):
        idx.get(np.array([999999]))


def test_flat_index_add_remove(small):
    """A flat index takes adds into its one partition (growing C) and
    stays exact."""
    x, ids, q = small
    flat = _build(x[:200], ids[:200], 0)
    flat.add(x[200:1000], ids[200:1000])
    assert flat.store.C == 1024 and flat.ntotal() == 1000 and flat.validate()
    flat.remove(ids[:100])
    gt, _ = knn(q, x[100:1000], 5, "l2", ids=ids[100:1000])
    assert compute_recall(flat.search(q, SearchParams(k=5)).ids, gt, 5) == 1.0
    _contract_6(flat.store)
