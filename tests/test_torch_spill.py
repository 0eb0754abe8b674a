"""A SOAR-spilled index (IndexBuildParams.spill: every vector stored twice,
in two different partitions) in the port against the JAX package, on the
CPU: `soar_assign`, the build, the fixed-nprobe search at B >= 16 (the fused
path with the dedup tail) and B < 16 (the query-major "xla" scan with
dedup), APS planned and loop (the scans at 2k, then `dedup_topk`), `add`,
`remove`, `modify`, `get`, an overflow split, `split_partitions`,
checkpoints each way and `validate`, and the search sharded over 4 virtual
CPU shards (the dedup merge of the shards' lists). The cases mirror
tests/test_spill.py; maintenance's are in test_torch_spill_maintenance.py.

The JAX package builds one spilled index (6000 x 32, nlist 32, the JAX
fixture's shape) and saves it; each test loads a fresh copy and carries it
across with `index_from_numpy`, whose mapping takes the two id maps
(`id_map`, `spill_map`). After every mutation both levels' arrays and
bookkeeping agree (placed by integer arithmetic: equal; the cached norms
are f32 sums in another order: rtol 1e-6), and so do both id maps; every id
is resident exactly twice, in two different partitions, each copy in the
map that says so (tests/test_spill.py::_two_residency_ok).

Tolerances: `soar_assign` equal (its closest SOAR scores here differ by
1e-3, far above f32 rounding); the scans on exact scores ("xla", the
query-major path, APS under QUAKE_TPU_KERNEL=xla) equal ids, or row overlap
>= 0.99 where APS plans can differ by one rank at a near-tie; the v11 path
against the JAX kernels in interpret mode overlap >= 0.99 and the common
ids' distances within rtol = atol = 1e-4 (keys quantized with floor()).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.kmeans import kmeans_fit_assign as jax_kmeans
from quake_tpu.kmeans import soar_assign as jax_soar_assign
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu.ops.pallas_grouped import grouped_scan_pallas_v11
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy
from quake_tpu_torch import index as tindex
from quake_tpu_torch.convert import FIELDS
from quake_tpu_torch.kmeans import soar_assign
from quake_tpu_torch.utils import compute_recall, knn
from test_torch_spill_ops import assert_no_dups, overlap
from test_torch_store_mutation import _assert_same, _contract_6

N0, D, NLIST = 6000, 32, 32


def _data(n, seed, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def saved_jax(tmp_path_factory):
    """The JAX package's spilled index over N0 vectors, saved once."""
    idx = JaxIndex()
    idx.build(_data(N0, 11), np.arange(N0), JaxBuildParams(nlist=NLIST, spill=True))
    path = str(tmp_path_factory.mktemp("jax_spill") / "idx")
    idx.save(path)
    return path


def carry_store(store) -> dict:
    """A JAX store's arrays, host bookkeeping and id maps, for index_from_numpy."""
    out = {f: np.asarray(getattr(store.state, f)) for f in FIELDS}
    out.update(free_rows=list(store.free_rows), generation=store.generation.copy(),
               cap_multiple=store.cap_multiple, id_map=store.id_map.items())
    if store.spill_map is not None:
        out["spill_map"] = store.spill_map.items()
    return out


def carry(jidx) -> QuakeIndex:
    return index_from_numpy(carry_store(jidx.store), carry_store(jidx.parent.store),
                            jidx.metric, device="cpu", soar_lambda=jidx.soar_lambda,
                            build_params=IndexBuildParams(nlist=jidx.build_params.nlist))


def two_residency(index, n_expected):
    """Every id resident exactly twice, in two different partitions, and
    the two maps name those partitions (tests/test_spill.py::
    _two_residency_ok, vectorized)."""
    st = index.store.state
    ids = st.ids.cpu().numpy() if isinstance(st.ids, torch.Tensor) else np.asarray(st.ids)
    rows, _ = np.nonzero(ids >= 0)
    flat = ids[ids >= 0].astype(np.int64)
    order = np.lexsort((rows, flat))
    flat, rows = flat[order], rows[order]
    assert len(flat) == 2 * n_expected
    assert (flat[0::2] == flat[1::2]).all() and len(np.unique(flat)) == n_expected
    assert (rows[0::2] != rows[1::2]).all()
    prim = index.store.id_map.get_batch(flat[0::2])
    spl = index.store.spill_map.get_batch(flat[0::2])
    assert (np.sort(np.stack([prim, spl], 1), 1) == np.stack([rows[0::2], rows[1::2]], 1)).all()


def assert_same_index(jidx, tidx):
    """Both levels' arrays, bookkeeping and id maps, the counts,
    validate(), contract 6 and the two-residency invariant."""
    assert jidx.validate() and tidx.validate()
    assert tidx.spill and jidx.spill
    for js, ts in ((jidx.store, tidx.store), (jidx.parent.store, tidx.parent.store)):
        _assert_same(js, ts)
        _contract_6(ts)
    assert (tidx.nlist(), tidx.ntotal(), tidx.parent.ntotal()) == (
        jidx.nlist(), jidx.ntotal(), jidx.parent.ntotal())
    assert int(tidx.store.state.sizes.sum()) == 2 * tidx.ntotal()
    two_residency(tidx, tidx.ntotal())


def _pair(saved):
    jidx = JaxIndex().load(saved)
    tidx = carry(jidx)
    assert_same_index(jidx, tidx)
    return jidx, tidx


def apply(jidx, tidx, method, *args):
    a, b = getattr(jidx, method)(*args), getattr(tidx, method)(*args)
    assert_same_index(jidx, tidx)
    return a, b


# ------------------------------------------------------------ soar_assign


@pytest.mark.parametrize("lam", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("given", [False, True])
def test_soar_assign_matches_jax(lam, given):
    """The same primary and spill partitions as the JAX package's (a
    precomputed primary kept as given), never the primary itself, in
    batches of 1000."""
    rng = np.random.default_rng(int(lam * 10) + given)
    x = _data(5000, 1)
    cents = x[rng.permutation(len(x))[:NLIST]] + 0.01
    primary = rng.integers(0, NLIST, len(x)) if given else None
    a1j, a2j = jax_soar_assign(x, cents, lam, primary=primary)
    a1, a2 = soar_assign(x, cents, lam, batch=1000, primary=primary)
    np.testing.assert_array_equal(a1, a1j)
    np.testing.assert_array_equal(a2, a2j)
    assert a1.dtype == a2.dtype == np.int32 and (a1 != a2).all()


# ------------------------------------------------------------------ build


def test_build_matches_jax(monkeypatch):
    """The port's build with the JAX package's k-means (its own clustering
    draws from torch.Generator): balancing, soar_assign against the
    balanced centroids with the balanced primaries, the doubled store and
    both maps, the parent, no calibration (a spilled store skips it)."""
    x = _data(N0, 11)

    def jax_fit(xt, nlist, metric="l2", niter=5):
        c, a = jax_kmeans(jnp.asarray(xt.numpy()), nlist, metric=metric, niter=niter)
        return torch.from_numpy(np.array(c)), torch.from_numpy(np.array(a))

    monkeypatch.setattr(tindex, "kmeans_fit_assign", jax_fit)
    bp = dict(nlist=NLIST, spill=True, soar_lambda=1.5, calibrate_aps=True)
    jidx = JaxIndex()
    jidx.build(x, np.arange(N0), JaxBuildParams(**bp))
    tidx = QuakeIndex(device="cpu")
    tidx.build(x, np.arange(N0), IndexBuildParams(**bp))
    assert tidx.soar_lambda == 1.5 and tidx.aps_radius_ab is None and tidx.aps_dimension > 0
    assert_same_index(jidx, tidx)


def test_flat_spill_raises():
    for index in (JaxIndex(), QuakeIndex(device="cpu")):
        with pytest.raises(ValueError, match="spill requires an IVF index"):
            index.build(_data(100, 16, 8), np.arange(100), IndexBuildParams(nlist=0, spill=True))


def test_carry_and_validate(saved_jax):
    """index_from_numpy carries spill, soar_lambda and both maps; validate()
    counts two residencies a vector; a spilled mapping without its id_map
    is refused."""
    jidx, tidx = _pair(saved_jax)
    assert tidx.soar_lambda == jidx.soar_lambda and tidx.ntotal() == N0
    st = carry_store(jidx.store)
    st.pop("id_map")
    with pytest.raises(ValueError, match="needs its id_map"):
        index_from_numpy(st, None, device="cpu")
    tidx.store.state.sizes[0] -= 1  # one slot fewer than the maps hold
    tidx.store.state.ids[0, int(tidx.store.state.sizes[0])] = -1
    assert not tidx.validate()


# ----------------------------------------------------------------- search


def test_fused_search_matches_jax_kernels(saved_jax, monkeypatch):
    """B >= 16 takes the fused path with the dedup tail, even with
    batched_scan=False: against the JAX package's parent ranking (K3's
    Pallas body) and v11 scan with dedup, in interpret mode."""
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    jidx, tidx = _pair(saved_jax)
    q = _data(64, 12)
    k, nprobe = 10, 6
    st, pst = jidx.store.state, jidx.parent.store.state
    qj = jnp.asarray(q)
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, qj, nprobe, "l2", interpret=True)
    pids = jnp.where(pids >= 0, pids, pids[:, :1])
    gpb = int(tidx._grouped_kernel()[len("v11g"):])
    sj, ij, _ = grouped_scan_pallas_v11(st.codes, st.ids, st.sizes, st.norms, qj, pids, k, "l2",
                                        qt=tidx._grouped_params(len(q), nprobe)[0], gpb=gpb,
                                        dedup=True, interpret=True)
    ij, dj = np.asarray(ij), np.sqrt(np.maximum(-np.asarray(sj), 0))
    for batched in (None, False):
        res = tidx.search(q, SearchParams(k=k, nprobe=nprobe, batched_scan=batched))
        assert_no_dups(res.ids)
        assert overlap(res.ids, ij) >= 0.99
        for b in range(len(q)):
            for i in set(res.ids[b].tolist()) & set(ij[b].tolist()):
                np.testing.assert_allclose(res.distances[b][res.ids[b] == i],
                                           dj[b][ij[b] == i], rtol=1e-4, atol=1e-4)


def test_spill_beats_single_assignment_per_probe():
    """tests/test_spill.py:42-65 on the port: the same clustering with and
    without spill (the build's k-means is seeded), recall@10 at nprobe 6
    higher with spill, full probe exact, no id twice."""
    x, q = _data(N0, 11), _data(64, 12)
    gt, _ = knn(q, x, 10, "l2")
    rec = {}
    for spill in (False, True):
        idx = QuakeIndex(device="cpu")
        idx.build(x, np.arange(N0), IndexBuildParams(nlist=NLIST, spill=spill))
        res = idx.search(q, SearchParams(k=10, nprobe=6))
        assert_no_dups(res.ids)
        rec[spill] = compute_recall(res.ids, gt, 10)
    assert rec[True] > rec[False]
    with _kernel("xla"):  # the exact scan: full probe finds every neighbour
        full = idx.search(q, SearchParams(k=10, nprobe=idx.nlist())).ids
    assert compute_recall(full, gt, 10) >= 0.999


class _kernel:
    """QUAKE_TPU_KERNEL set for a block, then restored."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prev = os.environ.get("QUAKE_TPU_KERNEL")
        os.environ["QUAKE_TPU_KERNEL"] = self.name

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("QUAKE_TPU_KERNEL")
        else:
            os.environ["QUAKE_TPU_KERNEL"] = self.prev


@pytest.mark.parametrize("B", [1, 8])
def test_query_major_matches_jax(saved_jax, B):
    """B < 16 takes grouped_scan_xla with dedup in both packages: ids equal."""
    jidx, tidx = _pair(saved_jax)
    q = _data(B, 13)
    rj = jidx.search(q, JaxSearchParams(k=10, nprobe=5))
    rt = tidx.search(q, SearchParams(k=10, nprobe=5))
    assert_no_dups(rt.ids)
    np.testing.assert_array_equal(rt.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rt.distances, np.asarray(rj.distances), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["planned", "loop", "oneshot"])
def test_aps_matches_jax(saved_jax, mode):
    """APS on a spilled index scans at 2k and keeps each id's best entry
    (dedup_topk): the same ids as the JAX package under QUAKE_TPU_KERNEL=xla
    (oneshot runs planned: no radius model, a spilled build does not
    calibrate), the same partitions scanned, recall >= 0.75 at target 0.8
    (tests/test_spill.py:93-108); then under the port's default v11."""
    jidx, tidx = _pair(saved_jax)
    x, q = _data(N0, 11), _data(32, 15)
    gt, _ = knn(q, x, 10, "l2")
    kw = dict(k=10, recall_target=0.8, initial_search_fraction=0.5, aps_mode=mode)
    with _kernel("xla"):
        rj = jidx.search(q, JaxSearchParams(**kw))
        rt = tidx.search(q, SearchParams(**kw))
    assert_no_dups(rt.ids)
    assert overlap(rt.ids, np.asarray(rj.ids)) >= 0.99
    assert rt.timing_info.partitions_scanned == rj.timing_info.partitions_scanned
    assert compute_recall(rt.ids, gt, 10) >= 0.75
    res = tidx.search(q, SearchParams(**kw))
    assert_no_dups(res.ids)
    assert compute_recall(res.ids, gt, 10) >= 0.75


def test_hand_calibrated_oneshot_runs_unfused(saved_jax, monkeypatch):
    """A radius model set by hand on a spilled index: oneshot ranks the
    parents first (the fused oneshot is off, as in the JAX package) and
    scans at 2k with dedup; ids as the JAX package's under "xla"."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    jidx, tidx = _pair(saved_jax)
    ab = np.stack([np.full(100, 0.5, np.float32), np.full(100, 1.2, np.float32)], 1)
    jidx.aps_radius_ab, tidx.aps_radius_ab = jnp.asarray(ab), ab
    q = _data(32, 16)
    kw = dict(k=10, recall_target=0.8, initial_search_fraction=0.5, aps_mode="oneshot")
    rj, rt = jidx.search(q, JaxSearchParams(**kw)), tidx.search(q, SearchParams(**kw))
    assert_no_dups(rt.ids)
    assert overlap(rt.ids, np.asarray(rj.ids)) >= 0.99


# --------------------------------------------------------------- mutation


def test_mutations_match_jax(saved_jax):
    """add (both copies placed by soar_assign against the active
    centroids), remove (both copies; some ids absent), modify (both copies),
    get, the mutation buffer's flush, re-adding removed ids."""
    jidx, tidx = _pair(saved_jax)
    x = _data(400, 17)
    apply(jidx, tidx, "add", x[:300], np.arange(10_000, 10_300))
    apply(jidx, tidx, "add", x[300], np.array([10_300]))  # one vector, 1-D
    apply(jidx, tidx, "remove", np.concatenate([np.arange(0, 250), np.arange(10_100, 10_150),
                                                np.array([77_777])]))
    new = _data(20, 18)
    apply(jidx, tidx, "modify", np.arange(1000, 1020), new)
    a, b = apply(jidx, tidx, "get", np.arange(1000, 1020))
    np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(b, new)
    codes = tidx.store.state.codes
    rows = [tidx.store.id_map.get_batch(np.array([1005]))[0],
            tidx.store.spill_map.get_batch(np.array([1005]))[0]]
    for r in rows:  # both copies carry the new vector
        slot = int(np.flatnonzero(tidx.store.state.ids[r].numpy() == 1005)[0])
        np.testing.assert_array_equal(codes[r, slot].numpy(), new[5])
    apply(jidx, tidx, "add", x[:10], np.arange(10))  # removed ids are re-addable
    for index in (jidx, tidx):
        with pytest.raises(ValueError):
            index.add(x[:1], np.array([5]))
    jidx.build_params.mutation_buffer_size = tidx.build_params.mutation_buffer_size = 64
    for i in range(3):
        jidx.add(x[320 + 20 * i:340 + 20 * i], np.arange(20_000 + 20 * i, 20_020 + 20 * i))
        tidx.add(x[320 + 20 * i:340 + 20 * i], np.arange(20_000 + 20 * i, 20_020 + 20 * i))
    assert len(tidx._pending_vids) == 3
    apply(jidx, tidx, "remove", np.array([20_005]))  # flushes first


def test_overflow_split_matches_jax(saved_jax):
    """A flood of tight copies of one vector (tests/test_spill.py:184-199):
    one combined splitting pass over both copies' targets, each written copy
    keeping its map; C unchanged, more partitions, the same store in both."""
    jidx, tidx = _pair(saved_jax)
    C0, nlist0 = tidx.store.C, tidx.nlist()
    rng = np.random.default_rng(19)
    x0 = _data(1, 11)[0]
    flood = x0 + 0.01 * rng.standard_normal((int(C0 * 1.5), D)).astype(np.float32)
    apply(jidx, tidx, "add", flood, np.arange(50_000, 50_000 + len(flood)))
    assert tidx.store.C == C0 and tidx.nlist() > nlist0
    res = tidx.search(flood[:16], SearchParams(k=1, nprobe=tidx.nlist()))
    assert (res.ids[:, 0] >= 50_000).all()


def test_split_partitions_matches_jax(saved_jax):
    """split_partitions on a spilled index takes the host path in both
    packages (kmeans_np), each copy keeping its map."""
    jidx, tidx = _pair(saved_jax)
    rows = [int(r) for r in tidx.store.active_rows()[[2, 5, 11]]]
    want, got = apply(jidx, tidx, "split_partitions", rows)
    assert got == want and len(got) == 6 and tidx.nlist() == NLIST + 3


# ------------------------------------------------------------ persistence


def test_checkpoints_cross_both_ways(saved_jax, tmp_path):
    """Each package loads the other's spilled checkpoint: spill and
    soar_lambda kept, the slots split between the maps by first occurrence
    in row-major order (both packages' rule), the same searches; a remove
    through the reloaded maps takes both copies."""
    jidx, tidx = _pair(saved_jax)
    q = _data(24, 14)
    before = tidx.search(q, SearchParams(k=10, nprobe=6)).ids
    tidx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    jl = JaxIndex().load(str(tmp_path / "t"))
    tl = QuakeIndex(device="cpu").load(str(tmp_path / "j"))
    tl2 = QuakeIndex(device="cpu").load(str(tmp_path / "t"))
    assert tl.spill and jl.spill and tl.soar_lambda == jidx.soar_lambda
    assert_same_index(jl, tl)
    assert_same_index(jl, tl2)
    np.testing.assert_array_equal(tl.search(q, SearchParams(k=10, nprobe=6)).ids, before)
    gone = before[0, :3]
    apply(jl, tl, "remove", gone)
    assert not np.isin(tl.store.state.ids.numpy(), gone).any()


def test_spill_sharded_matches_single_device(monkeypatch, tmp_path):
    """tests/test_spill.py::test_spill_sharded_matches_single_device in the
    port: a spilled build (4000 x 16, nlist 16, seed 17) sharded over 4
    virtual CPU shards returns per row the single-device id set, no id
    twice; APS on the sharded spilled index (the scans at 2k, the dedup
    tail) holds no id twice and reaches recall >= 0.75 (under "xla" it
    equals the unsharded APS). Then both packages load one JAX-built
    spilled store, each sharded 4 ways: under "xla" the port's ids equal
    the JAX package's (the local 2k scan with dedup, the dedup'd merge)."""
    rng = np.random.default_rng(17)
    n, d = 4000, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((24, d)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, np.arange(n, dtype=np.int64),
              IndexBuildParams(nlist=16, metric="l2", spill=True))
    sp = SearchParams(k=10, nprobe=5)
    aps = SearchParams(k=10, recall_target=0.8, initial_search_fraction=0.5)
    before = idx.search(q, sp)
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    aps_before = idx.search(q, aps).ids
    monkeypatch.delenv("QUAKE_TPU_KERNEL")
    idx.shard(4)
    assert idx.store.C % 512 == 0 and idx.validate()
    after = idx.search(q, sp)
    for b in range(q.shape[0]):
        assert set(before.ids[b].tolist()) == set(after.ids[b].tolist()), b
    assert_no_dups(after.ids)
    gt, _ = knn(q, x, 10, "l2")
    rid = idx.search(q, aps).ids
    assert_no_dups(rid)
    assert compute_recall(rid, gt, 10) >= 0.75
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    np.testing.assert_array_equal(idx.search(q, aps).ids, aps_before)

    jidx = JaxIndex()
    jidx.build(x, np.arange(n, dtype=np.int64),
               JaxBuildParams(nlist=16, metric="l2", spill=True, calibrate_aps=False))
    path = str(tmp_path / "jax_spill")
    jidx.save(path)
    jidx.shard(4)
    tidx = QuakeIndex(device="cpu").load(path)
    tidx.shard(4)
    got = tidx.search(q, sp)
    want = jidx.search(q, JaxSearchParams(k=10, nprobe=5))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5, atol=1e-5)
    assert_no_dups(got.ids)
