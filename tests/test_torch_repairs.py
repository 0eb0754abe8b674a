"""The v10 scan, the v11 placement knobs, the query-tile height, the parent's
search parameters, the index accessors and the port's deliberate deviations, quake_tpu_torch
against the JAX package on the same inputs (CPU).

The JAX side runs its Pallas kernels in interpret mode (the dispatch tests
wrap its Pallas scans so that they do); the torch side runs the plain PyTorch
versions of the kernels (the wrappers take them for CPU tensors). Inputs come
from numpy seeds and go to both packages as numpy.

Tolerances: the scans quantize f32 dot products with floor(), so a different
order of summation can move a key by one level and swap a tie at the top-k
boundary: they compare id overlap (>= 0.99) and the exact distances of common
ids (rtol = atol = 1e-4). Within the port, results that must not depend on a
choice (the query-tile height) are compared for equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quake_tpu.coordinator as jax_coordinator
import quake_tpu.ops.pallas_grouped as jax_pallas
from quake_tpu.index import QuakeIndex as JaxQuakeIndex
from quake_tpu.kmeans import kmeans_fit_assign as jax_kmeans
from quake_tpu.ops.pallas_flat import flat_topk_pallas
from quake_tpu.ops.scan import topk_from_scores as jax_topk_from_scores
from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, coordinator, index_from_numpy
from quake_tpu_torch.kmeans import kmeans_fit_assign
from quake_tpu_torch.ops.flat_topk import flat_topk
from quake_tpu_torch.ops.grouped_scan import grouped_scan_v10, grouped_scan_v11
from quake_tpu_torch.ops.scan import topk_from_scores


def _t(a):
    return torch.from_numpy(np.array(a))


def _row_overlap(a, b):
    """Mean over rows of |set(a_row) & set(b_row)| / |set(b_row)| (-1 ignored)."""
    tot = 0.0
    for ra, rb in zip(a, b):
        sa, sb = set(ra[ra >= 0].tolist()), set(rb[rb >= 0].tolist())
        tot += len(sa & sb) / max(len(sb), 1) if sb else float(not sa)
    return tot / len(a)


def _store(P, C, D, seed, sizes):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    sizes = np.asarray(sizes, np.int32)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0  # poison: must never be selected
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, sizes, norms


def _agree(got, want):
    """(scores, ids, scanned) of the port against the JAX package's."""
    s1, i1, c1 = (np.asarray(a) for a in want)
    s2, i2, c2 = (a.numpy() for a in got)
    np.testing.assert_array_equal(c2, c1)
    assert _row_overlap(i2, i1) >= 0.99
    for b in range(i1.shape[0]):
        for v in set(i1[b][i1[b] >= 0].tolist()) & set(i2[b][i2[b] >= 0].tolist()):
            np.testing.assert_allclose(s2[b][i2[b] == v][0], s1[b][i1[b] == v][0],
                                       rtol=1e-4, atol=1e-4)
    assert np.isneginf(s2[i2 < 0]).all()


def _masked_case(seed, B=40, nprobe=4):
    """A store with an empty partition (its groups are ghosts) and a pid
    matrix holding -1 entries and duplicates."""
    P, C, D = 8, 256, 16
    codes, ids, sizes, norms = _store(P, C, D, seed, [256, 200, 0, 17, 130, 256, 1, 90])
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(-1, P, size=(B, nprobe)).astype(np.int32)
    pids[:, 0] = 2  # every query probes the empty partition: a ghost group
    pids[1, 1] = pids[1, 2]
    pids[5] = -1  # a query that probes nothing
    return codes, ids, sizes, norms, q, pids


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_v10_matches_pallas(metric):
    args = _masked_case(seed=3)
    want = jax_pallas.grouped_scan_pallas_v10(*(jnp.asarray(a) for a in args), 10, metric,
                                              qt=8, gpb=2, interpret=True)
    got = grouped_scan_v10(*(_t(a) for a in args), 10, metric, qt=8, gpb=2)
    _agree(got, want)
    assert (got[1][5] == -1).all() and int(got[2][5]) == 0


def _jax_interpreted(monkeypatch, calls):
    """Makes the JAX dispatch run its v10 and v11 scans in interpret mode and
    record (name, placement) of each call."""
    for name in ("v10", "v11"):
        real = getattr(jax_pallas, f"grouped_scan_pallas_{name}")

        def wrapped(*a, _n=name, _real=real, **kw):
            calls.append((_n, kw.get("placement", "scatter" if _n == "v10" else "sorted")))
            return _real(*a, interpret=True, **kw)

        monkeypatch.setattr(jax_pallas, f"grouped_scan_pallas_{name}", wrapped)


def _port_recorded(monkeypatch, calls):
    """Records (name, placement) of each v10 and v11 call the port's dispatch makes."""
    for name in ("v10", "v11"):
        real = getattr(coordinator, f"grouped_scan_{name}")

        def wrapped(*a, _n=name, _real=real, **kw):
            calls.append((_n, kw.get("placement", "scatter" if _n == "v10" else "sorted")))
            return _real(*a, **kw)

        monkeypatch.setattr(coordinator, f"grouped_scan_{name}", wrapped)


def test_v11_without_dense_matches_jax_dispatch(monkeypatch):
    """v11 without the dense promise rides the v10 scatter placement in both
    packages, with the same results."""
    jax_calls, port_calls = [], []
    _jax_interpreted(monkeypatch, jax_calls)
    _port_recorded(monkeypatch, port_calls)
    args = _masked_case(seed=5)
    want = jax_coordinator.grouped_scan(*(jnp.asarray(a) for a in args), 10, "l2", 8, 8,
                                        "v11g2", dense=False)
    got = coordinator.grouped_scan(*(_t(a) for a in args), 10, "l2", 8, 8, "v11g2",
                                   dense=False)
    assert jax_calls == port_calls == [("v10", "scatter")]
    _agree(got, want)


@pytest.mark.parametrize("knob", [None, "argsort"])
def test_placement_knob_matches_jax_dispatch(monkeypatch, knob):
    """QUAKE_TPU_V11_PLACEMENT=argsort forces the argsort placement where the
    sort key fits, in both packages, with the same results."""
    if knob:
        monkeypatch.setenv("QUAKE_TPU_V11_PLACEMENT", knob)
    else:
        monkeypatch.delenv("QUAKE_TPU_V11_PLACEMENT", raising=False)
    jax_calls, port_calls = [], []
    _jax_interpreted(monkeypatch, jax_calls)
    _port_recorded(monkeypatch, port_calls)
    codes, ids, sizes, norms, q, pids = _masked_case(seed=7)
    pids = np.where(pids >= 0, pids, 0).astype(np.int32)  # dense
    args = (codes, ids, sizes, norms, q, pids)
    want = jax_coordinator.grouped_scan(*(jnp.asarray(a) for a in args), 10, "l2", 8, 8,
                                        "v11g2", dense=True)
    got = coordinator.grouped_scan(*(_t(a) for a in args), 10, "l2", 8, 8, "v11g2",
                                   dense=True)
    assert jax_calls == port_calls == [("v11", knob or "sorted")]
    _agree(got, want)


@pytest.mark.parametrize("placement,overflow,want", [
    (None, None, ("v11", "argsort")),
    (None, "v10", ("v10", "scatter")),
    ("argsort", None, ("v11", "argsort")),
    ("argsort", "v10", ("v10", "scatter")),
])
def test_overflow_knob_matches_jax_dispatch(monkeypatch, placement, overflow, want):
    """Where the sort key overflows (B = 8192: 13 bits, 262,176 kernel rows:
    19 bits), v11 takes the argsort placement, or v10 under
    QUAKE_TPU_V11_OVERFLOW=v10, in both packages. Shapes only: the scans are
    replaced by recorders."""
    for var, val in (("QUAKE_TPU_V11_PLACEMENT", placement), ("QUAKE_TPU_V11_OVERFLOW", overflow)):
        if val:
            monkeypatch.setenv(var, val)
        else:
            monkeypatch.delenv(var, raising=False)
    calls = {"jax": [], "port": []}
    for side, module, prefix in (("jax", jax_pallas, "grouped_scan_pallas_"),
                                 ("port", coordinator, "grouped_scan_")):
        for name in ("v10", "v11"):
            monkeypatch.setattr(module, prefix + name,
                                lambda *a, _n=name, _s=side, **kw: calls[_s].append(
                                    (_n, kw.get("placement", "scatter"))))
    B, nprobe, P = 8192, 32, 4
    q, pids = np.zeros((B, 8), np.float32), np.zeros((B, nprobe), np.int32)
    codes = np.zeros((P, 128, 8), np.float32)
    jax_coordinator.grouped_scan(jnp.asarray(codes), None, None, None, jnp.asarray(q),
                                 jnp.asarray(pids), 10, "l2", 8, 8, "v11", dense=True)
    coordinator.grouped_scan(_t(codes), None, None, None, _t(q), _t(pids), 10, "l2", 8, 8,
                             "v11", dense=True)
    assert calls["jax"] == calls["port"] == [want]


@pytest.mark.parametrize("placement", ["sorted", "argsort"])
def test_query_tile_height_changes_no_result(placement):
    """A kernel row's selection reads only its own query and its partition,
    so with the placement held fixed v11 at qt = 64 and qt = 8 (the heights
    the index may pick by D) returns the same ids and scores."""
    codes, ids, sizes, norms, q, pids = _masked_case(seed=11, B=96, nprobe=5)
    pids = np.where(pids >= 0, pids, 1).astype(np.int32)
    args = [_t(a) for a in (codes, ids, sizes, norms, q, pids)]
    s64, i64, c64 = grouped_scan_v11(*args, 10, "l2", qt=64, gpb=4, placement=placement)
    s8, i8, c8 = grouped_scan_v11(*args, 10, "l2", qt=8, gpb=4, placement=placement)
    assert torch.equal(i64, i8) and torch.equal(s64, s8) and torch.equal(c64, c8)


@pytest.mark.parametrize("target,want", [(0.81, 0.9), (0.9999, 0.99), (-1.0, -1.0), (0.0, 0.0)])
def test_parent_search_params(monkeypatch, target, want):
    """The parent's SearchParams carry the caller's fields as in the JAX
    package (quake_tpu/index.py::_search_device): a positive recall target
    becomes min(0.99, sqrt(target))."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 8)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=16, calibrate_aps=False))
    seen = []
    real = idx.parent._search_device

    def spy(q, sp, approx_flat=False):
        seen.append(sp)
        return real(q, sp, approx_flat)

    monkeypatch.setattr(idx.parent, "_search_device", spy)
    sp = SearchParams(k=5, nprobe=3, recall_target=target, use_precomputed=False,
                      recompute_threshold=0.125, initial_search_fraction=0.5, batched_scan=False)
    idx._search_device(torch.from_numpy(x[:4]), sp)
    (psp,) = seen
    assert psp.recall_target == pytest.approx(want)
    assert (psp.use_precomputed, psp.recompute_threshold, psp.initial_search_fraction) == (
        False, 0.125, 0.5)
    assert (psp.k, psp.nprobe, psp.batched_scan) == (8, 3, True)


@pytest.mark.parametrize("N,D", [(384, 13), (128, 200)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_topk_wide_and_odd_depth_match_pallas(N, D, metric):
    """K3's plain version at an odd depth and at a depth past the old limit
    of its first CUDA design, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(N + D)
    B, k = 48, 9
    codes = rng.standard_normal((N, D)).astype(np.float32)
    norms = (codes ** 2).sum(1)
    ok = np.arange(N) < N - 40
    bias = np.where(ok, -norms if metric == "l2" else 0.0, -np.inf).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = np.asarray(flat_topk_pallas(jnp.asarray(codes), jnp.asarray(bias), jnp.asarray(q), k,
                                       metric, qt=8, interpret=True))
    got = flat_topk(_t(codes), _t(bias), _t(q), k, metric).numpy()
    assert not np.isin(got, np.arange(N - 40, N)).any()
    assert _row_overlap(got, want) >= 0.99


# ------------------------------------------------ deviations kept on purpose


def test_deviation_reference_name(monkeypatch):
    """"reference" is a dispatch name of the port only: it runs the plain
    exact scan of the probed partitions. The JAX dispatch knows no such name
    and runs its exact "xla" scan for it, which selects the same ids."""
    calls = []
    real = coordinator.reference_scan
    monkeypatch.setattr(coordinator, "reference_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    codes, ids, sizes, norms, q, pids = _masked_case(seed=13)
    args = (codes, ids, sizes, norms, q, pids)
    got = coordinator.grouped_scan(*(_t(a) for a in args), 10, "l2", 8, 8, "reference")
    want = jax_coordinator.grouped_scan(*(jnp.asarray(a) for a in args), 10, "l2", 8, 8,
                                        "reference")
    assert calls == [1]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_deviation_cpu_index_runs_v11(monkeypatch):
    """Without QUAKE_TPU_KERNEL a CPU index runs v11 on the plain versions;
    the JAX package runs "xla" off the TPU."""
    monkeypatch.delenv("QUAKE_TPU_KERNEL", raising=False)
    rng = np.random.default_rng(1)
    idx = QuakeIndex(device="cpu")
    idx.build(rng.standard_normal((1000, 8)).astype(np.float32), None,
              IndexBuildParams(nlist=8, calibrate_aps=False))
    assert idx._grouped_kernel() == "v11g4"
    assert JaxQuakeIndex()._grouped_kernel() == "xla"


def test_deviation_approx_topk_is_exact():
    """topk_from_scores(approx=True) selects exactly (the port has no
    approximate reducer), as the JAX package's approx_max_k does on the CPU:
    the same ids as the exact selection, on rows wide enough for the
    approximate branch (M > 256, k <= 128)."""
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((16, 1000)).astype(np.float32)
    ids = np.tile(np.arange(1000, dtype=np.int32), (16, 1))
    s_a, i_a = topk_from_scores(_t(scores), _t(ids), 20, approx=True)
    s_e, i_e = topk_from_scores(_t(scores), _t(ids), 20)
    assert torch.equal(i_a, i_e) and torch.equal(s_a, s_e)
    _, i_j = jax_topk_from_scores(jnp.asarray(scores), jnp.asarray(ids), 20, approx=True)
    np.testing.assert_array_equal(i_a.numpy(), np.asarray(i_j))


def test_deviation_kmeans_generator():
    """kmeans_fit_assign draws its random choices from a torch.Generator
    seeded with `seed`: the same seed gives the same clustering, another
    seed another one, and neither reproduces jax.random's assignments, so
    the packages are compared on quality
    (tests/test_torch_index.py::test_kmeans_inertia_matches_jax)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 8)).astype(np.float32)
    c0, a0 = kmeans_fit_assign(torch.from_numpy(x), 16, niter=4, seed=0)
    c0b, a0b = kmeans_fit_assign(torch.from_numpy(x), 16, niter=4, seed=0)
    _, a1 = kmeans_fit_assign(torch.from_numpy(x), 16, niter=4, seed=1)
    assert torch.equal(c0, c0b) and torch.equal(a0, a0b)
    assert not torch.equal(a0, a1)
    _, ja = jax_kmeans(jnp.asarray(x), 16, niter=4, seed=0)
    assert not np.array_equal(np.asarray(ja), a0.numpy())



@pytest.mark.parametrize("case", ["flat", "ivf", "ivf with a deleted partition"])
def test_accessors_match_jax(case):
    """centroids(), parent_ntotal() and ntotal() of one state, carried from
    the JAX package's build into the port (convert.index_from_numpy): the
    active partitions' centroids in the JAX order. A partition deleted from
    the middle of the store leaves a free row between active ones."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((1500, 8)) + 4.0 * rng.integers(0, 6, (1500, 1))).astype(np.float32)
    jidx = JaxQuakeIndex()
    jidx.build(x, np.arange(len(x)), JaxBuildParams(nlist=0 if case == "flat" else 12,
                                                     calibrate_aps=False))
    if case == "ivf with a deleted partition":
        jidx.store.delete_partitions([3])
    fields = ("codes", "ids", "sizes", "centroids", "active", "norms")

    def arrays(state):
        return {f: np.asarray(getattr(state, f)) for f in fields}

    tidx = index_from_numpy(arrays(jidx.store.state),
                            arrays(jidx.parent.store.state) if jidx.parent else None, "l2",
                            device="cpu")
    np.testing.assert_array_equal(tidx.store.active_rows(), jidx.store.active_rows())
    np.testing.assert_array_equal(tidx.centroids(), np.asarray(jidx.centroids()))
    assert isinstance(tidx.centroids(), np.ndarray)
    assert tidx.parent_ntotal() == jidx.parent_ntotal()
    assert (tidx.parent_ntotal() == 0) == (case == "flat")
    assert tidx.ntotal() == jidx.ntotal()
    assert tidx.centroids().shape == (tidx.nlist(), 8)
