"""The port's store mutation path against the JAX package's, on the CPU.

The same sequence of builds, appends, removes, updates, partition writes
and deletes runs through quake_tpu.storage.store.PartitionStore and
quake_tpu_torch.storage.store.PartitionStore; after every step the six
store arrays must agree (placed by integer arithmetic: equal; the cached
norms are f32 sums in another order: rtol 1e-6, as in test_torch_store.py),
and so must the host bookkeeping: free rows, generation counters, ntotal,
nlist, partition sizes and the resident-id map. The cases mirror
tests/test_store.py.
"""

import numpy as np
import pytest
import torch

from quake_tpu.storage.store import PartitionStore as JaxStore
from quake_tpu_torch.ops.grouped_chunked import (grouped_scan_v4, grouped_scan_v5,
                                                 grouped_scan_v6)
from quake_tpu_torch.ops.grouped_family import (grouped_scan_v3p, grouped_scan_v3pn,
                                                grouped_scan_v7, grouped_scan_v8)
from quake_tpu_torch.ops.grouped_variants import grouped_scan_packed
from quake_tpu_torch.storage import store as tstore
from quake_tpu_torch.storage.store import PartitionStore
from test_torch_store import _assert_same_store


def _id_map(m) -> dict:
    keys, rows = m.items()
    return dict(zip(np.asarray(keys).tolist(), np.asarray(rows).tolist()))


def _assert_same(js, ts):
    """Arrays and bookkeeping of the two stores agree (on a spilled store
    both id maps)."""
    _assert_same_store(js.state, ts.state)
    assert (ts.P, ts.C, ts.nlist(), ts.ntotal()) == (js.P, js.C, js.nlist(), js.ntotal())
    assert ts.free_rows == js.free_rows
    np.testing.assert_array_equal(ts.generation, js.generation)
    assert ts.cap_multiple == js.cap_multiple
    rows = np.array([-1] + list(range(js.P)) + [0, -1])
    np.testing.assert_array_equal(ts.partition_sizes(rows), js.partition_sizes(rows))
    np.testing.assert_array_equal(ts.partition_sizes(), js.partition_sizes())
    assert _id_map(ts.id_map) == _id_map(js.id_map)
    assert ts.spill == js.spill
    if js.spill:
        assert _id_map(ts.spill_map) == _id_map(js.spill_map)
    np.testing.assert_array_equal(np.sort(ts.get_ids()), np.sort(js.get_ids()))


def _contract_6(ts):
    """Compact prefix and norms (ROADMAP Queue 3 contract 6): ids >= 0
    exactly below the sizes, norms at valid slots equal the codes' squared
    norms, the id map counts every valid slot (on a spilled store the two
    maps together)."""
    st = ts.state
    lane = torch.arange(ts.C)[None, :]
    below = lane < st.sizes[:, None]
    assert torch.equal(st.ids >= 0, below)
    torch.testing.assert_close(st.norms[below], (st.codes * st.codes).sum(-1)[below],
                               rtol=1e-6, atol=0)
    assert ts.ntotal() + (len(ts.spill_map) if ts.spill else 0) == int(st.sizes.sum())


def _both(n=256, d=8, nlist=4, seed=0, cap_multiple=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    assigns = rng.integers(0, nlist, n).astype(np.int32)
    js, ts = JaxStore(d), PartitionStore(d, "cpu")
    js.init_from_assignments(x, ids, cents, assigns, cap_multiple=cap_multiple)
    ts.init_from_assignments(x, ids, cents, assigns, cap_multiple=cap_multiple)
    _assert_same(js, ts)
    return js, ts, x, ids, rng


def _apply(js, ts, method, *args):
    """The same call on both stores; their results must agree too."""
    a, b = getattr(js, method)(*args), getattr(ts, method)(*args)
    if isinstance(a, tuple):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(v), np.asarray(u))
    else:
        assert a == b
    _assert_same(js, ts)
    _contract_6(ts)
    return b


@pytest.mark.parametrize("cap_multiple", [128, 384])
def test_build_with_cap_multiple(cap_multiple):
    js, ts, *_ = _both(n=700, nlist=2, cap_multiple=cap_multiple)
    assert ts.C % cap_multiple == 0
    _contract_6(ts)


def test_append_and_get():
    js, ts, x, ids, rng = _both()
    newv = rng.standard_normal((5, 8)).astype(np.float32)
    newids = np.arange(1000, 1005, dtype=np.int64)
    _apply(js, ts, "append", np.array([0, 0, 1, 2, 3], dtype=np.int32), newv, newids)
    assert ts.ntotal() == 261
    vecs, found = _apply(js, ts, "get_vectors", newids)
    assert found.all()
    np.testing.assert_allclose(vecs, newv, rtol=1e-6)


def test_append_duplicate_rows_in_batch():
    """Ten vectors to one row in one batch take consecutive slots in batch
    order; a pad row (-1) is skipped."""
    js, ts, *_ = _both()
    n0 = int(ts.partition_sizes()[0])
    newv = np.arange(80, dtype=np.float32).reshape(10, 8)
    rows = np.zeros(10, dtype=np.int32)
    rows[3] = -1
    _apply(js, ts, "append", rows, newv, np.arange(2000, 2010, dtype=np.int64))
    assert int(ts.partition_sizes()[0]) == n0 + 9
    np.testing.assert_array_equal(ts.state.ids[0, n0:n0 + 9].numpy(),
                                  [2000, 2001, 2002, 2004, 2005, 2006, 2007, 2008, 2009])


@pytest.mark.parametrize("cap_multiple", [128, 384])
def test_append_overflow_grows_capacity(cap_multiple):
    """A batch that overflows a row grows C to next_pow2(need, 2 C) rounded
    up to cap_multiple; the grown tensors are contiguous (contract 7)."""
    js, ts, *_, rng = _both(n=16, nlist=2, cap_multiple=cap_multiple)
    C0 = ts.C
    n_new = 2 * C0 + 5
    newids = np.arange(10_000, 10_000 + n_new, dtype=np.int64)
    rows = rng.integers(0, 2, n_new).astype(np.int32)
    rows[:C0 + 10] = 1
    _apply(js, ts, "append", rows, rng.standard_normal((n_new, 8)).astype(np.float32), newids)
    assert ts.C > C0 and ts.C % cap_multiple == 0
    st = ts.state
    assert all(t.is_contiguous() for t in (st.codes, st.ids, st.norms))
    _, found = _apply(js, ts, "get_vectors", newids)
    assert found.all()


def test_remove_and_compaction():
    """Removal compacts each row's prefix by a stable keep-first order: the
    slots past the new size hold the same stale codes and norms in both
    packages. Ids that are not present are ignored."""
    js, ts, x, ids, rng = _both()
    to_remove = np.concatenate([ids[::10], [999_999, -5]])
    assert _apply(js, ts, "remove", to_remove) == len(ids[::10])
    assert ts.ntotal() == 256 - len(ids[::10])
    _, found = _apply(js, ts, "get_vectors", ids[::10])
    assert not found.any()
    keep = np.setdiff1d(ids, ids[::10])
    vecs, found = _apply(js, ts, "get_vectors", keep)
    assert found.all()
    np.testing.assert_allclose(vecs, x[keep], rtol=1e-6)
    assert _apply(js, ts, "remove", ids[::10]) == 0  # already gone


def test_remove_nonexistent_is_noop():
    js, ts, *_ = _both()
    assert _apply(js, ts, "remove", np.array([999999], dtype=np.int64)) == 0
    assert ts.ntotal() == 256


def test_update_vectors_and_get():
    """update_vectors overwrites codes and norms in place; an id that is not
    resident is skipped."""
    js, ts, x, ids, rng = _both()
    upd_ids = np.array([0, 1, 2, 123_456], dtype=np.int64)
    upd = np.full((4, 8), 42.0, np.float32)
    _apply(js, ts, "update_vectors", upd_ids, upd)
    v, found = _apply(js, ts, "get_vectors", upd_ids)
    assert found.tolist() == [True, True, True, False]
    np.testing.assert_allclose(v[:3], upd[:3])
    assert (v[3] == 0).all() and ts.ntotal() == 256


def test_partition_lifecycle():
    """allocate_rows, write_partitions, delete_partitions, set_centroids."""
    js, ts, *_ = _both()
    rows = _apply(js, ts, "allocate_rows", 2)
    cents = np.ones((2, 8), np.float32)
    vecs = [np.full((3, 8), i, np.float32) for i in range(2)]
    vids = [np.arange(5000 + 10 * i, 5003 + 10 * i, dtype=np.int64) for i in range(2)]
    _apply(js, ts, "write_partitions", rows, vecs, vids, cents)
    assert ts.nlist() == 6
    v, found = _apply(js, ts, "get_vectors", vids[1])
    assert found.all()
    np.testing.assert_allclose(v, vecs[1])
    _apply(js, ts, "delete_partitions", [rows[0]])
    assert ts.nlist() == 5
    _, found = _apply(js, ts, "get_vectors", vids[0])
    assert not found.any()
    _apply(js, ts, "set_centroids", [rows[1], 0], np.full((2, 8), 3.0, np.float32))
    # A deleted row is reused first, its generation moved on again.
    again = _apply(js, ts, "allocate_rows", 1)
    assert again == [rows[0]] and ts.generation[rows[0]] == 3
    assert _apply(js, ts, "get_partition", rows[1])[1].tolist() == vids[1].tolist()


def test_write_partitions_grows_capacity_without_rounding():
    """A written partition larger than C grows C to next_pow2(size, 2 C),
    without cap_multiple's rounding (the JAX package's rule there): with
    cap_multiple 384 and C re-bucketed to 512, a 600-row partition grows C
    to 1024, where ensure_capacity would give 1152."""
    js, ts, x, ids, rng = _both(n=300, nlist=2, cap_multiple=384)
    _apply(js, ts, "ensure_capacity_multiple", 256)
    assert (ts.C, ts.cap_multiple) == (512, 384)
    rows = _apply(js, ts, "allocate_rows", 1)
    _apply(js, ts, "write_partitions", rows, [rng.standard_normal((600, 8)).astype(np.float32)],
           [np.arange(50_000, 50_600)], np.zeros((1, 8), np.float32))
    assert ts.C == 1024


def test_row_growth():
    """allocate_rows past the free rows grows P to max(ceil128(needed),
    P + 128); the old free rows are taken first, then the new ones."""
    js, ts, *_ = _both()
    P0 = ts.P
    _apply(js, ts, "ensure_rows", 1)
    assert ts.P == P0
    rows = _apply(js, ts, "allocate_rows", P0 + 1)
    assert ts.P == P0 + 128 and rows[:2] == [4, 5] and rows[P0 - 4] == P0


def test_ensure_capacity_multiple():
    js, ts, *_ = _both(n=600, nlist=2)
    C0 = ts.C
    _apply(js, ts, "ensure_capacity_multiple", 256)
    assert ts.C % 256 == 0 and ts.C >= C0 and ts.cap_multiple == 256
    _apply(js, ts, "ensure_capacity_multiple", 100)  # rounds to 128: no change
    assert ts.cap_multiple == 256


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_sequence(seed):
    """A seeded sequence of every mutation, compared after each step:
    appends with repeated rows and an overflow that grows C, removes with
    absent ids, updates, partition writes (with their own growth), deletes,
    row growth past P, new centroids and a capacity multiple."""
    js, ts, x, ids, rng = _both(n=500, d=16, nlist=6, seed=seed)
    next_id = 10_000
    for step in range(3):
        n = int(rng.integers(20, 120))
        rows = rng.integers(-1, 6, n).astype(np.int32)
        _apply(js, ts, "append", rows, rng.standard_normal((n, 16)).astype(np.float32),
               np.arange(next_id, next_id + n))
        next_id += n
        resident = np.sort(ts.get_ids())
        gone = rng.choice(resident, size=len(resident) // 5, replace=False)
        _apply(js, ts, "remove", np.concatenate([gone, [next_id + 7]]))
        upd = rng.choice(np.sort(ts.get_ids()), size=9, replace=False)
        _apply(js, ts, "update_vectors", upd, rng.standard_normal((9, 16)).astype(np.float32))
        _apply(js, ts, "get_vectors", np.concatenate([upd, gone[:3]]))
    flood = ts.C + 40  # one row past C
    _apply(js, ts, "append", np.full(flood, 2, np.int32),
           rng.standard_normal((flood, 16)).astype(np.float32), np.arange(next_id, next_id + flood))
    next_id += flood
    new_rows = _apply(js, ts, "allocate_rows", 3)
    sizes = [0, 5, 2 * ts.C + 1]
    _apply(js, ts, "write_partitions", new_rows,
           [rng.standard_normal((s, 16)).astype(np.float32) for s in sizes],
           [np.arange(next_id + 10_000 * i, next_id + 10_000 * i + s) for i, s in enumerate(sizes)],
           rng.standard_normal((3, 16)).astype(np.float32))
    _apply(js, ts, "delete_partitions", [new_rows[1], 0])
    _apply(js, ts, "allocate_rows", ts.P)  # grows P by 128 or more
    _apply(js, ts, "set_centroids", [1, 3], rng.standard_normal((2, 16)).astype(np.float32))
    _apply(js, ts, "ensure_capacity_multiple", 3 * 128)
    _apply(js, ts, "remove", ts.get_ids()[:50])
    _apply(js, ts, "get_partition", 2)


def test_device_functions_drop_pads_and_out_of_range_slots():
    """The device functions skip rows of -1 and drop writes past C, as JAX's
    mode="drop" scatters do; sizes still count the dropped appends."""
    js, ts, *_ = _both(n=20, nlist=2)
    st = ts.state
    C = ts.C
    sizes0 = st.sizes.clone()
    rows = torch.tensor([-1] + [0] * (C + 2), dtype=torch.int32)
    vecs = torch.ones((C + 3, 8))
    st = tstore._append(st, rows, vecs, torch.arange(C + 3) + 7000)
    assert int(st.sizes[0]) == int(sizes0[0]) + C + 2
    assert int((st.ids[0] >= 7000).sum()) == C - int(sizes0[0])
    st, n_removed = tstore._remove_compact(st, torch.tensor([-1, 1], dtype=torch.int32),
                                           torch.tensor([3, 2 ** 31 - 1], dtype=torch.int32))
    assert int(n_removed) == int((js.state.ids[1] == 3).sum())


@pytest.mark.parametrize("axis", ["C", "P"])
def test_growth_past_ref_packing_raises_in_the_wrappers(axis):
    """Contract 3 (ROADMAP Queue 3): the scans that pack (pid << 16) | slot
    need P < 32768 and C <= 65536. Store growth can cross either bound (D =
    4: a flood of 66,000 appends to one row grows C to 131072; allocating
    32768 rows grows P past it); every wrapper that packs refs then
    raises."""
    rng = np.random.default_rng(3)
    ts = PartitionStore(4, "cpu")
    ts.init_from_assignments(rng.standard_normal((64, 4)), np.arange(64),
                             rng.standard_normal((2, 4)), np.arange(64) % 2)
    if axis == "C":
        n = 66_000
        ts.append(np.zeros(n, np.int32), rng.standard_normal((n, 4)).astype(np.float32),
                  np.arange(1000, 1000 + n))
        assert ts.C == 131072
    else:
        ts.allocate_rows(32768)
        assert ts.P >= 32768
    _contract_6(ts)
    st = ts.state
    q = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    pids = torch.zeros((3, 2), dtype=torch.int32)
    args = (st.codes, st.ids, st.sizes, st.norms, q, pids, 5, "l2")
    for scan in (grouped_scan_v3p, grouped_scan_v3pn, grouped_scan_v7, grouped_scan_v8,
                 grouped_scan_v4, grouped_scan_v5, grouped_scan_v6):
        with pytest.raises(ValueError, match=r"packs \(pid, slot\) into int32"):
            scan(*args)
    with pytest.raises(ValueError, match=r"packs \(pid, slot\) into int32"):
        grouped_scan_packed(st.codes, st.ids, q, pids, 5, "l2")


def test_spill_arguments_raise_by_name():
    """Lifted (the name kept as it was): the spill arguments and methods run
    as in the JAX package on a spilled store (every vector stored twice,
    id_map holding the primary copy and spill_map the second): the build
    with spill_assignments, append with spill_rows (spill copies first),
    append_spill_copies, append_primaries, remove of both copies (an id in
    one map only counts too), update of both copies, write_partitions with
    spill_flags_list and delete_partitions erasing from the map whose copy
    lived in the row; arrays and both maps equal after every step."""
    rng = np.random.default_rng(5)
    n, d, nlist = 256, 8, 4
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    a1 = rng.integers(0, nlist, n).astype(np.int32)
    a2 = ((a1 + rng.integers(1, nlist, n)) % nlist).astype(np.int32)
    js, ts = JaxStore(d), PartitionStore(d, "cpu")
    js.init_from_assignments(x, ids, cents, a1, spill_assignments=a2)
    ts.init_from_assignments(x, ids, cents, a1, spill_assignments=a2)
    _assert_same(js, ts)
    assert ts.spill and ts.ntotal() == n and int(ts.state.sizes.sum()) == 2 * n
    v = rng.standard_normal((3, d)).astype(np.float32)
    _apply(js, ts, "append", np.array([0, 1, 2]), v, np.array([900, 901, 902]),
           np.array([1, 2, 3]))
    _apply(js, ts, "append_spill_copies", np.array([3, -1]), v[:2], np.array([903, 904]))
    _apply(js, ts, "append_primaries", np.array([2, 0]), v[:2], np.array([903, 904]))
    _apply(js, ts, "remove", np.array([0, 5, 901, 99_999]))
    _apply(js, ts, "update_vectors", np.array([7, 902]), v[:2])
    np.testing.assert_array_equal(ts.get_vectors(np.array([7]))[0][0], v[0])
    _apply(js, ts, "delete_partitions", [1, 3])
    rows = _apply(js, ts, "allocate_rows", 2)
    flags = [np.array([True, False]), np.array([False])]
    _apply(js, ts, "write_partitions", rows, [v[:2], v[2:]], [np.array([905, 906]),
                                                              np.array([907])], v[:2], flags)
    assert ts.spill_map.get_batch(np.array([905]))[0] == rows[0]
    assert ts.id_map.get_batch(np.array([906, 907])).tolist() == rows