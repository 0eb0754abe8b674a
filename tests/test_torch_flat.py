"""The flat scan, the query-major IVF scan, the duplicate-dropping merge and
the parent-ranking choice, quake_tpu_torch against the JAX package on the same
inputs (CPU); and a flat and an IVF index carried across with convert.py and
searched through both packages at every routing of QuakeIndex.search.

No hand-written kernel is on these paths in either package, except kernel K3
behind parent_kernel="pallas" (its plain version here, the Pallas kernel in
interpret mode there). Tolerances: scores within rtol = atol = 1e-5 (one f32
dot product summed in another order), distances 1e-4 (a square root of a
difference of such sums), ids equal wherever a row's scores are distinct.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu import coordinator as jax_coordinator
from quake_tpu.ops import scan as jax_scan
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu_torch import QuakeIndex, SearchParams, coordinator, index_from_numpy
from quake_tpu_torch.ops import scan

FIELDS = ("codes", "ids", "sizes", "centroids", "active", "norms")


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_ranked_equal(s1, i1, s2, i2, tol=1e-5):
    """Scores close; ids equal at every rank whose score stands clear of its
    neighbours' (a tie may order either way)."""
    np.testing.assert_allclose(s2, s1, rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(s1, axis=1))
    gap = np.where(np.isnan(gap), 0.0, gap)  # inf next to inf
    lim = 1e-4 * (1.0 + np.abs(np.where(np.isfinite(s1), s1, 0.0)))
    clear = np.ones_like(s1, bool)
    clear[:, 1:] &= gap > lim[:, 1:]
    clear[:, :-1] &= gap > lim[:, :-1]
    np.testing.assert_array_equal(i2[clear], i1[clear])
    assert (i2[~np.isfinite(s2)] == -1).all()


def _flat_inputs(N, D, B, seed):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((N, D)).astype(np.float32)
    ids = rng.permutation(N).astype(np.int32)
    ids[rng.random(N) < 0.2] = -1
    codes[ids < 0] = 10.0
    return codes, ids, rng.standard_normal((B, D)).astype(np.float32)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("N,chunk,k", [(300, 8192, 10), (1000, 256, 10), (1000, 300, 400),
                                       (40, 16, 60)])
def test_flat_scan_matches_jax(N, chunk, k, metric, approx):
    """One chunk and the chunked running merge (a last chunk that is short,
    k above the chunk size, k above N)."""
    codes, ids, q = _flat_inputs(N, 16, 9, N + k)
    s1, i1 = jax_scan.flat_scan(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(ids), k, metric,
                                chunk_size=chunk, approx=approx)
    s2, i2 = scan.flat_scan(_t(q), _t(codes), _t(ids), k, metric, chunk_size=chunk,
                            approx=approx)
    assert tuple(s2.shape) == tuple(s1.shape) == (9, min(k, N)) and i2.dtype == torch.int32
    _assert_ranked_equal(np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [5, 200])
def test_ivf_scan_matches_jax(metric, k):
    rng = np.random.default_rng(k)
    P, C, D, B, nprobe = 8, 128, 16, 10, 4
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = rng.permutation(P * C).astype(np.int32).reshape(P, C)
    for p, sz in enumerate([128, 0, 77, 1, 128, 64, 12, 100]):
        ids[p, sz:] = -1
        codes[p, sz:] = 10.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    pids[0, 1:] = -1
    pids[1, :] = -1
    pids[2, :] = 1  # only the empty partition
    s1, i1, n1 = jax_scan.ivf_scan(jnp.asarray(q), jnp.asarray(pids), jnp.asarray(codes),
                                   jnp.asarray(ids), None, k, metric)
    s2, i2, n2 = scan.ivf_scan(_t(q), _t(pids), _t(codes), _t(ids), None, k, metric)
    assert n2.dtype == torch.int32
    np.testing.assert_array_equal(n2.numpy(), np.asarray(n1))
    _assert_ranked_equal(np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy())
    s3, i3, n3 = coordinator.ivf_search(_t(codes), _t(ids), _t(q), _t(pids), k, metric)
    assert torch.equal(s3, s2) and torch.equal(i3, i2) and torch.equal(n3, n2)


@pytest.mark.parametrize("k", [4, 12, 40])
def test_dedup_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    B, pool = 7, 24
    scores = rng.standard_normal((B, pool)).astype(np.float32)
    ids = rng.integers(-1, 9, (B, pool)).astype(np.int32)  # many repeats
    scores[ids < 0] = -np.inf
    s1, i1 = jax_scan.dedup_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    s2, i2 = scan.dedup_topk(_t(scores), _t(ids), k)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    for row in i2.numpy():
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


@pytest.mark.parametrize("M,k", [(300, 10), (300, 200), (100, 10)])
def test_topk_from_scores_approx_matches_jax(M, k):
    """Wide rows with a small k take the approximate reducer in the JAX
    package (exact on the CPU) and torch.topk here; the rest the stable sort."""
    rng = np.random.default_rng(M + k)
    scores = rng.standard_normal((6, M)).astype(np.float32)
    scores[:, ::7] = -np.inf
    scores[5] = -np.inf
    ids = rng.permutation(6 * M).astype(np.int32).reshape(6, M)
    s1, i1 = jax_scan.topk_from_scores(jnp.asarray(scores), jnp.asarray(ids), k, approx=True)
    s2, i2 = scan.topk_from_scores(_t(scores), _t(ids), k, approx=True)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    s3, i3 = scan.topk_from_scores(_t(scores), _t(ids), k)
    assert torch.equal(s3, s2) and torch.equal(i3, i2)


# ------------------------------------------------------------ parent ranking


def _parent(metric, seed=3):
    rng = np.random.default_rng(seed)
    Pp, Cp, D, B = 2, 128, 16, 40
    codes = rng.standard_normal((Pp, Cp, D)).astype(np.float32)
    ids = np.arange(Pp * Cp, dtype=np.int32).reshape(Pp, Cp)
    ids[1, 100:] = -1
    codes[1, 100:] = 10.0
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, norms, rng.standard_normal((B, D)).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rank_parents_approx_matches_jax(metric):
    codes, ids, norms, q = _parent(metric)
    want = jax_coordinator.rank_parents(*(jnp.asarray(a) for a in (codes, ids, norms, q)), 8,
                                        metric, "approx")
    got = coordinator.rank_parents(_t(codes), _t(ids), _t(norms), _t(q), 8, metric, "approx")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # "approx" is the default, and what "pallas" falls back to without norms.
    assert torch.equal(coordinator.rank_parents(_t(codes), _t(ids), _t(norms), _t(q), 8, metric),
                       got)
    assert torch.equal(coordinator.rank_parents(_t(codes), _t(ids), None, _t(q), 8, metric,
                                                "pallas"), got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rank_parents_pallas_matches_jax(metric):
    """Kernel K3's plain version against the Pallas kernel in interpret mode:
    both rank by a quantized key, so rows compare by overlap."""
    codes, ids, norms, q = _parent(metric)
    want = np.asarray(parent_rank_pallas(*(jnp.asarray(a) for a in (codes, ids, norms, q)), 8,
                                         metric, qt=8, interpret=True))
    got = coordinator.rank_parents(_t(codes), _t(ids), _t(norms), _t(q), 8, metric,
                                   "pallas").numpy()
    overlap = np.mean([len(set(a) & set(b)) / 8 for a, b in zip(got, want)])
    assert overlap >= 0.99
    exact = coordinator.rank_parents(_t(codes), _t(ids), _t(norms), _t(q), 8, metric).numpy()
    assert (got[:, 0] == exact[:, 0]).all()  # the best partition survives the quantization


# ------------------------------------------------------- indexes, end to end


def clustered(n, d, n_centers, seed):
    rng = np.random.default_rng(99)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3.0
    r = np.random.default_rng(seed)
    return (centers[r.integers(0, n_centers, n)]
            + r.standard_normal((n, d)).astype(np.float32))


def _arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def indexes():
    """A flat and an IVF index built by the JAX package and carried across."""
    x = clustered(6000, 16, 60, seed=3)
    q = clustered(64, 16, 60, seed=4)
    out = {}
    for name, nlist in (("flat", 0), ("ivf", 24)):
        j = JaxIndex()
        j.build(x, np.arange(len(x)), JaxBuildParams(nlist=nlist, calibrate_aps=False))
        parent = _arrays(j.parent.store.state) if j.parent is not None else None
        out[name] = (j, index_from_numpy(_arrays(j.store.state), parent, "l2", device="cpu"))
    return out, q


@pytest.mark.parametrize("batched_scan", [None, True, False])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_search_routes_match_jax(indexes, monkeypatch, kind, B, batched_scan):
    """QuakeIndex.search of both packages on one store: the flat index, and
    the IVF index query-major (B < 16 or batched_scan=False), partition-major
    in tensor operations (batched_scan=True below 16 queries) and fused
    (B >= 16; the scan pinned to "xla", which the JAX package runs off the
    TPU)."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    idx, q = indexes
    jidx, tidx = idx[kind]
    assert (tidx.parent is None) == (kind == "flat")
    k, nprobe = 10, 6
    want = jidx.search(q[:B], JaxSearchParams(k=k, nprobe=nprobe, batched_scan=batched_scan))
    got = tidx.search(q[:B], SearchParams(k=k, nprobe=nprobe, batched_scan=batched_scan))
    assert got.ids.shape == (B, k) and got.ids.dtype == np.int64
    assert got.distances.dtype == np.float32 and (got.ids >= 0).all()
    assert got.timing_info.partitions_scanned == want.timing_info.partitions_scanned
    _assert_ranked_equal(want.distances, want.ids, got.distances, got.ids, tol=1e-4)


def test_flat_index_is_exact(indexes):
    from quake_tpu_torch.utils import compute_recall, knn

    idx, q = indexes
    jidx, tidx = idx["flat"]
    x = np.asarray(jidx.store.state.codes).reshape(-1, 16)[: tidx.ntotal()]
    ids = np.asarray(jidx.store.state.ids).reshape(-1)[: tidx.ntotal()]
    gt, _ = knn(q, x, 10, ids=ids)
    assert compute_recall(tidx.search(q, SearchParams(k=10)).ids, gt, 10) == 1.0
    assert compute_recall(tidx.search(q[:3], SearchParams(k=10)).ids, gt[:3], 10) == 1.0


def test_parent_kernel_choice(indexes, monkeypatch):
    """QUAKE_TPU_PARENT_KERNEL reaches rank_parents through the fused search;
    without it a CPU index ranks with "approx"."""
    idx, q = indexes
    _, tidx = idx["ivf"]
    monkeypatch.delenv("QUAKE_TPU_PARENT_KERNEL", raising=False)
    assert tidx._parent_kernel() == "approx"
    seen = []
    real = coordinator.rank_parents

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(coordinator, "rank_parents", spy)
    sp = SearchParams(k=5, nprobe=4)
    base = tidx.search(q, sp)
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    assert tidx._parent_kernel() == "pallas"
    other = tidx.search(q, sp)
    assert seen == ["approx", "pallas"]
    overlap = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(base.ids, other.ids)])
    assert overlap >= 0.9


def test_cuda_index_defaults_to_the_kernel_parent_ranking(monkeypatch):
    monkeypatch.delenv("QUAKE_TPU_PARENT_KERNEL", raising=False)
    idx = QuakeIndex(device="cpu")
    idx.device = torch.device("cuda")  # only the choice is read, nothing runs
    assert idx._parent_kernel() == "pallas"
