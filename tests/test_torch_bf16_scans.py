"""bf16 codes on every scan kernel of the port, on the CPU, against the JAX
package: kernels K3-K9, sized_topk and multi_topk, which the JAX package's
Pallas kernels run on bf16 codes (each wrapper rounds the query to the
codes' dtype, each body multiplies with an f32 accumulator).

One bf16 store (12 partitions of C = 256 rows, D = 16, uneven sizes with an
empty partition, made from a numpy seed and rounded to bf16 by JAX) is
carried across with convert.store_from_numpy, its bits kept. Each of the 12
scans runs there on both packages with the same probe lists, at both
metrics: the port's plain versions (the wrappers take them for CPU
tensors) against the Pallas kernels in interpret mode, the by-name scans
through each package's dispatch by name, the direct scans through their
entry points. The tolerances are those of each scan's f32 test:

  * the exact selections (v3, v2, approx, sized, multi) select on f32
    scores of exact bf16 products summed in another order: scores within
    rtol = atol = 1e-5, ids equal wherever a row's scores are distinct
    (test_torch_exact_chunked.py::_assert_exact_match);
  * the quantized keys with an exact rescore (v3p, v3pN, v6, v7, v4, v5,
    packed): a key can move by one level and swap a near-tie at the top-k
    boundary, so row overlap >= 0.99 and the exact distances of the common
    ids within rtol = atol = 1e-4 (_assert_rescored_match);
  * K3 (`flat_topk_plain` through `parent_rank`) on bf16 parent codes
    against `parent_rank_pallas(interpret=True)`: row overlap >= 0.99 and
    the exact best partition first (test_torch_flat.py's K3 case).

A bf16 parent (IndexBuildParams(parent_params=IndexBuildParams(
precision="bf16"))), both ways: a JAX-built index carried across and
searched, mutated, saved and loaded into the other package (parent codes
bit for bit, ids equal or overlapping as in test_torch_precision.py), and
the port's own build, maintenance and split, each parent row the bf16
rounding of its partition's centroid. A three-level JAX index whose IVF
mid level is bf16, carried across over its chain of parents, searched,
saved and loaded both ways, every level bit for bit. maintenance() on a
JAX-built bf16 parent (flat, and the mid level of three) in both packages:
the same splits and deletes, the bf16 parent rows bit for bit.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import MaintenancePolicyParams as JaxPolicyParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu import coordinator as jax_coordinator
from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator as JaxLatency
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu_torch import (IndexBuildParams, MaintenancePolicyParams, QuakeIndex, SearchParams,
                             coordinator, index_from_numpy)
from quake_tpu_torch.maintenance import ListScanLatencyEstimator
from quake_tpu_torch.convert import FIELDS, store_from_numpy
from quake_tpu_torch.ops import grouped_variants as gv
from test_torch_exact_chunked import _assert_exact_match, _assert_rescored_match, _row_overlap
from test_torch_spill import carry_store

BY_NAME = ("v3p", "v3p4", "v6", "v7g4", "v4", "v5", "v3", "v2")
DIRECT = ("approx", "sized", "packed", "multi")
SCANS = BY_NAME + DIRECT
EXACT = ("v3", "v2", "approx", "sized", "multi")  # selections on the f32 scores themselves
P, C, D, B, NPROBE, QT, K = 12, 256, 16, 32, 4, 8, 10
# The Pallas wrappers the JAX dispatch (quake_tpu/coordinator.py::grouped_scan)
# reaches by name; it calls them without `interpret`.
_PALLAS = ("grouped_scan_pallas", "grouped_scan_pallas_v3", "grouped_scan_pallas_v3p",
           "grouped_scan_pallas_v3pn", "grouped_scan_pallas_v4", "grouped_scan_pallas_v5",
           "grouped_scan_pallas_v6", "grouped_scan_pallas_v7")


def _bits(codes) -> np.ndarray:
    """int16 view of bf16 codes, from either package."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.int16).numpy()
    return np.asarray(codes).view(np.int16)


def interpret_pallas(monkeypatch) -> None:
    """Every Pallas wrapper the JAX dispatch reaches by name, in interpret
    mode (the CPU cannot lower them)."""
    for name in _PALLAS:
        monkeypatch.setattr(jpg, name, functools.partial(getattr(jpg, name), interpret=True))


def bf16_store_arrays(seed: int = 3):
    """A bf16 store as the JAX package holds one: codes rounded to bf16 by
    JAX (zero past each size), ids shuffled (slot and id order differ), the
    cached norms the f32 squared norms of the rounded codes."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(([C, C - 56, 0, 5, C, C // 2, 1, 90, C - 1, 130, C, 17] * 2)[:P],
                       np.int32)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = rng.permutation(P * C).astype(np.int32).reshape(P, C)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 0.0
    jcodes = jnp.asarray(codes, jnp.bfloat16)
    norms = np.asarray(jnp.sum(jcodes.astype(jnp.float32) ** 2, axis=2))
    centroids = rng.standard_normal((P, D)).astype(np.float32)
    return dict(codes=np.asarray(jcodes), ids=ids, sizes=sizes, norms=norms, centroids=centroids,
                active=np.ones(P, bool))


def bf16_queries(seed: int = 4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:NPROBE] for _ in range(B)]).astype(np.int32)
    pids[3, 2] = -1
    pids[5, :] = -1  # a query with no probe
    return q, pids


@pytest.fixture(scope="module")
def bf16_store():
    """(the store's numpy arrays, the port's state carried by convert.py)."""
    arrays = bf16_store_arrays()
    state = store_from_numpy(arrays, "cpu").state
    assert state.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(state.codes), _bits(arrays["codes"]))
    return arrays, state


def run_scan(monkeypatch, scan, arrays, state, q, pids, k, metric):
    """One scan on both packages: (JAX result, port result) as numpy
    triples (scores, ids, scanned)."""
    j = tuple(jnp.asarray(arrays[f]) for f in ("codes", "ids", "sizes", "norms"))
    t = (state.codes, state.ids, state.sizes, state.norms)
    jq, jp, tq, tp = jnp.asarray(q), jnp.asarray(pids), torch.from_numpy(q), torch.from_numpy(pids)
    if scan in BY_NAME:
        interpret_pallas(monkeypatch)
        want = jax_coordinator.grouped_scan(*j, jq, jp, k, metric, qt=QT, group_chunk=8,
                                            kernel=scan)
        got = coordinator.grouped_scan(*t, tq, tp, k, metric, QT, 8, scan)
    elif scan == "sized":
        want = jpg.grouped_scan_pallas_sized(j[0], j[1], j[2], jq, jp, k, metric, qt=QT, ct=128,
                                             interpret=True)
        got = gv.grouped_scan_sized(t[0], t[1], t[2], tq, tp, k, metric, qt=QT, ct=128)
    elif scan == "multi":
        want = jpg.grouped_scan_pallas_multi(j[0], j[1], jq, jp, k, metric, qt=QT, gb=4,
                                             interpret=True)
        got = gv.grouped_scan_multi(t[0], t[1], tq, tp, k, metric, qt=QT, gb=4)
    else:
        want = getattr(jpg, f"grouped_scan_pallas_{scan}")(j[0], j[1], jq, jp, k, metric, qt=QT,
                                                           interpret=True)
        got = getattr(gv, f"grouped_scan_{scan}")(t[0], t[1], tq, tp, k, metric, qt=QT)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def assert_scan_matches(scan, want, got, ids, pids):
    """The tolerance of the scan's f32 test (see the module's docstring)."""
    (s1, i1, n1), (s2, i2, n2) = want, got
    assert s2.shape == s1.shape and s2.dtype == np.float32 and i2.dtype == np.int32
    np.testing.assert_array_equal(n2, n1)
    if scan in EXACT:
        _assert_exact_match(s1, i1, s2, i2)
    else:
        _assert_rescored_match(s1, i1, s2, i2, ids, pids)


# ------------------------------------------------------------------ the scans


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("scan", SCANS)
def test_scan_matches_jax_on_bf16(monkeypatch, bf16_store, scan, metric):
    arrays, state = bf16_store
    q, pids = bf16_queries()
    want, got = run_scan(monkeypatch, scan, arrays, state, q, pids, K, metric)
    assert_scan_matches(scan, want, got, arrays["ids"], pids)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_parent_rank_matches_pallas_on_bf16(metric):
    """K3's plain version on bf16 parent codes (the query rounded to bf16 as
    pallas_flat.py:75 rounds it) against the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(11)
    Pp, Cp, nprobe = 2, 128, 8
    codes = np.asarray(jnp.asarray(rng.standard_normal((Pp, Cp, D)), jnp.bfloat16))
    ids = np.arange(Pp * Cp, dtype=np.int32).reshape(Pp, Cp)
    ids[1, 100:] = -1
    norms = np.asarray(jnp.sum(jnp.asarray(codes).astype(jnp.float32) ** 2, axis=2))
    q = rng.standard_normal((40, D)).astype(np.float32)
    want = np.asarray(parent_rank_pallas(*(jnp.asarray(a) for a in (codes, ids, norms, q)), nprobe,
                                         metric, qt=8, interpret=True))
    tcodes = store_from_numpy(dict(codes=codes, ids=ids, sizes=np.full(Pp, Cp, np.int32),
                                   norms=norms, centroids=np.zeros((Pp, D), np.float32),
                                   active=np.ones(Pp, bool)), "cpu").state.codes
    args = (tcodes, torch.from_numpy(ids), torch.from_numpy(norms), torch.from_numpy(q))
    got = coordinator.rank_parents(*args, nprobe, metric, "pallas").numpy()
    assert _row_overlap(got, want) >= 0.99
    exact = coordinator.rank_parents(*args, nprobe, metric).numpy()
    assert (got[:, 0] == exact[:, 0]).all()  # the best partition survives the quantization


# ------------------------------------------------------------ a bf16 parent


def _parent_bp(**kw):
    return IndexBuildParams(nlist=16, calibrate_aps=False,
                            parent_params=IndexBuildParams(precision="bf16"), **kw)


def _data(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _arrays(store):
    out = {f: np.asarray(getattr(store.state, f)) for f in FIELDS}
    out.update(free_rows=list(store.free_rows), generation=store.generation.copy(),
               cap_multiple=store.cap_multiple)
    return out


@pytest.fixture(scope="module")
def jax_bf16_parent():
    """A JAX index over 3,000 x 16 vectors, 16 partitions, its flat parent
    in bf16."""
    idx = JaxIndex()
    idx.build(_data(3000, 1), np.arange(3000),
              JaxBuildParams(nlist=16, niter=5, calibrate_aps=False,
                             parent_params=JaxBuildParams(precision="bf16")))
    assert idx.parent.store.state.codes.dtype == jnp.bfloat16
    return idx


def _assert_parent_rows_round_centroids(idx):
    """Each resident partition's parent row is the bf16 rounding of its
    centroid (the parent's ids are the partition ids)."""
    pst, st = idx.parent.store.state, idx.store.state
    assert pst.codes.dtype == torch.bfloat16
    rows = pst.ids.numpy() >= 0
    pids = pst.ids.numpy()[rows]
    want = jnp.asarray(st.centroids.numpy()[pids], jnp.bfloat16)
    np.testing.assert_array_equal(_bits(pst.codes)[rows], _bits(want))


def test_bf16_parent_carried_searches_as_jax(monkeypatch, jax_bf16_parent, tmp_path):
    """The JAX-built bf16 parent carried across: parent codes bit for bit;
    the fused search (the parent ranked by the flat scan on bf16 codes in
    both packages, QUAKE_TPU_KERNEL=xla in both) equal ids, distances within
    rtol 1e-5; add and remove on both, then the search again; the port's
    save loads into the JAX package and the JAX package's into the port,
    parent codes bit for bit and the precision in each level's metadata."""
    jidx = jax_bf16_parent
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    bp = IndexBuildParams(nlist=16, precision="f32")
    tidx = index_from_numpy(_arrays(jidx.store), _arrays(jidx.parent.store), jidx.metric,
                            device="cpu", build_params=bp)
    assert tidx.parent.store.state.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tidx.parent.store.state.codes),
                                  _bits(jidx.parent.store.state.codes))
    q = _data(64, 9)

    def same_search():
        a = jidx.search(q, JaxSearchParams(k=10, nprobe=4))
        b = tidx.search(q, SearchParams(k=10, nprobe=4))
        np.testing.assert_array_equal(b.ids, np.asarray(a.ids))
        np.testing.assert_allclose(b.distances, np.asarray(a.distances), rtol=1e-5, atol=1e-5)

    same_search()
    x_new = _data(200, 5)
    for idx in (jidx, tidx):
        idx.add(x_new, np.arange(10_000, 10_200))
        idx.remove(np.arange(0, 300, 3))
    same_search()

    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tidx.save(tpath)
    jidx.save(jpath)
    for path in (tpath, jpath):
        with open(os.path.join(path, "parent", "metadata.json")) as f:
            assert json.load(f)["precision"] == "bf16"
    j_from_t = JaxIndex().load(tpath)
    t_from_j = QuakeIndex(device="cpu").load(jpath)
    for loaded in (j_from_t.parent.store.state.codes, t_from_j.parent.store.state.codes):
        np.testing.assert_array_equal(_bits(loaded), _bits(jidx.parent.store.state.codes))
    assert t_from_j.parent.store.state.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_from_j.search(q, SearchParams(k=10, nprobe=4)).ids,
                                  np.asarray(j_from_t.search(q, JaxSearchParams(k=10,
                                                                                nprobe=4)).ids))


def test_bf16_parent_ranks_on_k3_as_pallas(jax_bf16_parent):
    """rank_parents "pallas" (K3's plain version) on the carried bf16 parent
    against the interpret-mode Pallas ranking of the JAX index's parent."""
    pst = jax_bf16_parent.parent.store.state
    q = _data(48, 12)
    want = np.asarray(parent_rank_pallas(pst.codes, pst.ids, pst.norms, jnp.asarray(q), 6, "l2",
                                         qt=8, interpret=True))
    tpst = store_from_numpy(_arrays(jax_bf16_parent.parent.store), "cpu").state
    got = coordinator.rank_parents(tpst.codes, tpst.ids, tpst.norms, torch.from_numpy(q), 6, "l2",
                                   "pallas").numpy()
    assert _row_overlap(got, want) >= 0.99


def test_bf16_parent_built_by_the_port(monkeypatch, tmp_path):
    """The port's own build of a bf16 parent: its rows the JAX package's
    bf16 rounding of the centroids; the search recall within 0.02 of an f32
    parent's; the 1-NN assignment of `add` through the parent (the flat
    scan on bf16 codes); maintenance() after a skewed window and a split,
    each parent row still the rounding of its centroid (the splits write
    into the bf16 store, rounded at the write); a save and a load keep the
    parent bf16 bit for bit."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    x = _data(3000, 2)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, _parent_bp())
    ref = QuakeIndex(device="cpu")
    ref.build(x, None, IndexBuildParams(nlist=16, calibrate_aps=False))
    _assert_parent_rows_round_centroids(idx)
    q = x[:200] + 0.01 * _data(200, 3)
    sp = SearchParams(k=10, nprobe=4)
    gt = np.arange(200)
    hit = np.mean(idx.search(q, sp).ids[:, 0] == gt)
    assert hit >= np.mean(ref.search(q, sp).ids[:, 0] == gt) - 0.02
    idx.add(_data(300, 4) + 2.0, np.arange(5000, 5300))
    assert idx.ntotal() == 3300 and idx.validate()

    idx.maintenance_policy.reset()
    skew = x[np.argsort(((x - x[0]) ** 2).sum(1))[:1000]]
    idx.search(skew, SearchParams(k=10, nprobe=2, batched_scan=False))
    idx.maintenance()
    idx.split_partitions(np.array([0]))
    assert idx.validate() and idx.parent.validate()
    _assert_parent_rows_round_centroids(idx)
    assert idx.parent.ntotal() == idx.nlist()

    path = str(tmp_path / "p")
    idx.save(path)
    back = QuakeIndex(device="cpu").load(path)
    np.testing.assert_array_equal(_bits(back.parent.store.state.codes),
                                  _bits(idx.parent.store.state.codes))
    np.testing.assert_array_equal(back.search(q, sp).ids, idx.search(q, sp).ids)


# ------------------------------------- a bf16 mid level, and maintenance into a bf16 parent

# JAX-built indexes, saved once: "flat" a leaf over a flat bf16 parent (the
# jax_bf16_parent build), "mid" three levels, the IVF mid level in bf16 over
# a flat f32 grandparent.
_LAYOUTS = {"flat": JaxBuildParams(nlist=16, niter=5, calibrate_aps=False,
                                   parent_params=JaxBuildParams(precision="bf16")),
            "mid": JaxBuildParams(nlist=32, niter=5, calibrate_aps=False,
                                  parent_params=JaxBuildParams(nlist=4, precision="bf16"))}


@pytest.fixture(scope="module")
def saved_bf16_parents(tmp_path_factory):
    paths = {}
    for name, bp in _LAYOUTS.items():
        j = JaxIndex()
        j.build(_data(3000, 1), np.arange(3000), bp)
        assert j.parent.store.state.codes.dtype == jnp.bfloat16
        paths[name] = str(tmp_path_factory.mktemp(f"bf16_{name}") / "idx")
        j.save(paths[name])
    return paths


def _chain(idx):
    out = []
    while idx is not None:
        out.append(idx)
        idx = idx.parent
    return out


def _assert_same_chain(j, t):
    """Every level of the two indexes: the same dtype and code bits, the
    same ids, each level valid."""
    jl, tl = _chain(j), _chain(t)
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        assert (b.store.state.codes.dtype == torch.bfloat16) == (a.store.state.codes.dtype
                                                                 == jnp.bfloat16)
        np.testing.assert_array_equal(_bits(b.store.state.codes), _bits(a.store.state.codes))
        np.testing.assert_array_equal(b.store.state.ids.numpy(), np.asarray(a.store.state.ids))
        assert b.validate() and a.validate()


def test_bf16_mid_level_chain_as_jax(monkeypatch, saved_bf16_parents, tmp_path):
    """A three-level JAX index whose IVF mid level is bf16, carried across
    with index_from_numpy over the chain of parent stores: every level's
    codes bit for bit; the search (the mid level scanned on its bf16 codes,
    QUAKE_TPU_KERNEL=xla in both) equal ids, distances within rtol 1e-5; the
    port's save loads into the JAX package and the JAX package's into the
    port, every level bit for bit, the mid level's metadata.json precision
    bf16, and the search ids equal again."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    path = saved_bf16_parents["mid"]
    j = JaxIndex().load(path)
    t = index_from_numpy(carry_store(j.store),
                         [carry_store(j.parent.store), carry_store(j.parent.parent.store)],
                         j.metric, device="cpu")
    assert t.parent.parent is not None and t.parent.nlist() == 4
    _assert_same_chain(j, t)
    q = _data(64, 9)
    sp, jsp = SearchParams(k=10, nprobe=8), JaxSearchParams(k=10, nprobe=8)
    a, b = j.search(q, jsp), t.search(q, sp)
    np.testing.assert_array_equal(b.ids, np.asarray(a.ids))
    np.testing.assert_allclose(b.distances, np.asarray(a.distances), rtol=1e-5, atol=1e-5)

    t.save(str(tmp_path / "t"))
    with open(tmp_path / "t" / "parent" / "metadata.json") as f:
        assert json.load(f)["precision"] == "bf16"
    j_from_t, t_from_j = JaxIndex().load(str(tmp_path / "t")), QuakeIndex(device="cpu").load(path)
    _assert_same_chain(j, t_from_j)
    _assert_same_chain(j_from_t, t)
    np.testing.assert_array_equal(t_from_j.search(q, sp).ids,
                                  np.asarray(j_from_t.search(q, jsp).ids))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_maintenance_into_a_bf16_parent(saved_bf16_parents, layout):
    """maintenance() on a JAX-built index whose parent is bf16 (flat, or
    the IVF mid level of three), loaded into both packages: the same window
    (hot rows and aged ones, recorded on the host) under a steep latency
    grid (L = 2000 n + k ns, as test_torch_multilevel.py's) makes the same
    splits and deletes; every leaf partition holds the same ids, the
    centroids of every level agree within 1e-5, and the bf16 parent's rows,
    written by the splits and rounded at the write, are equal bit for bit;
    every level valid."""
    path = saved_bf16_parents[layout]
    j, t = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    for idx, cls in ((j, JaxLatency), (t, ListScanLatencyEstimator)):
        grid = cls(D, packaged=False)
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
    rest = order[2:]
    hot = [int(r) for r in rest[np.argsort(np.abs(sizes[rest] - sizes[rest].mean()),
                                           kind="stable")][:2]]
    for _ in range(60):
        j.maintenance_policy.record_query_hits(hot)
        t.maintenance_policy.record_query_hits(hot)
    wi, ti = j.maintenance(), t.maintenance()
    assert (ti.n_splits, ti.n_deletes) == (wi.n_splits, wi.n_deletes)
    assert ti.n_splits > 0 and ti.n_deletes > 0
    assert (t.nlist(), t.ntotal()) == (j.nlist(), j.ntotal())
    for a, b in zip(_chain(t), _chain(j)):
        rows = a.store.active_rows()
        np.testing.assert_array_equal(rows, b.store.active_rows())
        if a.parent is not None:
            np.testing.assert_allclose(a.store.state.centroids.numpy()[rows],
                                       np.asarray(b.store.state.centroids)[rows],
                                       rtol=1e-5, atol=1e-5)
        assert a.validate() and b.validate()
    assert t.parent.store.state.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t.parent.store.state.codes),
                                  _bits(j.parent.store.state.codes))
    assert t.parent.ntotal() == t.nlist()
