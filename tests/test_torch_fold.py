"""Fold widths other than 128 on kernels K1 and K5, the tensor-operation pool
merge (merge="xla") and ListScanLatencyEstimator.profile_scan_latency,
quake_tpu_torch against the JAX package on the same inputs (CPU).

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions of K1 and K5 (the wrappers take them for CPU tensors). Inputs
come from numpy seeds and go to both packages as numpy.

Tolerances: the scans quantize f32 dot products with floor(), so another
order of summation can move a key by one level and swap a tie at the top-k
boundary: they compare id overlap (>= 0.99, contract 1) and the exact
distances of the common ids at rtol = atol = 1e-5 (the same f32 rescore in
both packages). The fold rounds, the merges and the flat scan at the grid's
points are compared exactly: their inputs are integers or the same floats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu.ops.scan import flat_scan as jax_flat_scan
from quake_tpu_torch import coordinator
from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator
from quake_tpu_torch.ops import grouped_family, grouped_scan
from quake_tpu_torch.ops.grouped_scan import (FOLD, fold_rounds, fold_served,
                                              grouped_scan_plain, packed_params)
from quake_tpu_torch.ops.scan import flat_scan
from test_torch_spill_ops import assert_no_dups, overlap


def _t(a):
    return torch.from_numpy(np.array(a))


def _store(P, C, D, seed):
    """Partitions of several sizes (one empty, one of a single segment, one
    ending inside a segment, full ones), padding poisoned with 10.0."""
    rng = np.random.default_rng(seed)
    sizes = np.array([C, C - 70, 0, 100, C, C // 2 + 3][:P], np.int32)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, sizes, norms


def _queries(B, D, P, nprobe, seed, masked=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    if masked:  # pairs that take no part (the masked APS scans)
        pids[1, 1:] = -1
        pids[4, 0] = -1
    return q, pids


def _assert_parity(want, got):
    """(scores, ids, scanned): scanned equal, no id twice, ids overlapping
    >= 0.99, the common ids' exact distances at rtol = atol = 1e-5."""
    sw, iw, nw = (np.asarray(a) for a in want)
    sg, ig, ng = (a.numpy() for a in got)
    np.testing.assert_array_equal(ng, nw)
    assert_no_dups(ig)
    assert overlap(ig, iw) >= 0.99
    for b in range(len(ig)):
        for i in set(ig[b][ig[b] >= 0].tolist()) & set(iw[b][iw[b] >= 0].tolist()):
            np.testing.assert_allclose(sg[b][ig[b] == i], sw[b][iw[b] == i], rtol=1e-5,
                                       atol=1e-5)


# ------------------------------------------------------- the scans, by fold

# (scan, C, fold): folds 64 and 256 on C = 512, 384 on C = 768 (K5 through
# v7, K1 through v11).
_SCANS = ("v7", "v8", "v9", "v10", "v11", "v10b")
_FOLD_CASES = [(s, 512, f) for s in _SCANS for f in (64, 256)] + [(s, 768, 384)
                                                                   for s in ("v7", "v11")]


@pytest.mark.parametrize("scan,C,fold", _FOLD_CASES)
def test_scan_at_fold_matches_jax(scan, C, fold):
    P, D, B, nprobe, qt, k = 6, 8, 24, 3, 8, 10
    codes, ids, sizes, norms = _store(P, C, D, seed=C + fold)
    q, pids = _queries(B, D, P, nprobe, seed=fold, masked=scan in ("v10", "v10b"))
    arrays = (codes, ids, sizes, norms, q, pids)
    jfn = getattr(jpg, f"grouped_scan_pallas_{scan}")
    kw = dict(qt=qt, gpb=1, fold=fold)  # gpb 1: the interpret-mode compile is the test's cost
    if scan == "v10b":
        kw["pair_budget"] = int((pids >= 0).sum())
    want = jfn(*(jnp.asarray(a) for a in arrays), k, "l2", interpret=True, **kw)
    fn = (grouped_scan.grouped_scan_v10b if scan == "v10b"
          else getattr(grouped_scan, f"grouped_scan_{scan}", None)
          or getattr(grouped_family, f"grouped_scan_{scan}"))
    got = fn(*(_t(a) for a in arrays), k, "l2", **kw)
    _assert_parity(want, got)


@pytest.mark.parametrize("kernel,C", [("v7g2f64", 512), ("v11g4f256", 512),
                                      ("v10g2f384", 768), ("v8f32", 256)])
def test_dispatch_passes_the_fold(monkeypatch, kernel, C):
    """A folded name reaches K1 (K5 for v7) with its fold, not v3pN."""
    seen = []
    for mod, fn in ((grouped_scan, "grouped_scan_kernel"), (grouped_family, "grouped_scan_kernel"),
                    (grouped_family, "rowscale_scan")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, **kw: seen.append(
            a[8] if _r.__name__ == "grouped_scan_kernel" else kw["fold"]) or _r(*a, **kw))
    codes, ids, sizes, norms = _store(6, C, 8, seed=3)
    q, pids = _queries(16, 8, 6, 2, seed=4)
    coordinator.grouped_scan(*(_t(a) for a in (codes, ids, sizes, norms, q, pids)), 10, "l2", 8,
                             8, kernel, dense=True)
    assert seen == [int(kernel.split("f")[1])]


@pytest.mark.parametrize("kernel,C", [("v11g4f96", 384), ("v7f16", 256), ("v8f192", 384),
                                      ("v10g2f160", 320)])
def test_fold_outside_the_served_set_raises(kernel, C):
    """A fold that divides C but that K1 and K5 do not serve raises
    ValueError naming the served set (a deliberate deviation: the JAX kernels
    run it in interpret mode only); one that does not divide C falls back to
    v3pN, as in the JAX package."""
    fold = int(kernel.split("f")[1])
    assert C % fold == 0 and not fold_served(fold)
    codes, ids, sizes, norms = _store(6, C, 8, seed=5)
    q, pids = _queries(16, 8, 6, 2, seed=6)
    args = [_t(a) for a in (codes, ids, sizes, norms, q, pids)]
    with pytest.raises(ValueError, match="32, 64 and the multiples of 128"):
        coordinator.grouped_scan(*args, 10, "l2", 8, 8, kernel, dense=True)
    scores, out_ids, _ = coordinator.grouped_scan(*args, 10, "l2", 8, 8,
                                                  kernel.replace(f"f{fold}", "f1024"),
                                                  dense=True)  # C % 1024 != 0: v3pN
    assert scores.shape == (16, 10) and (out_ids >= 0).any()


def test_served_folds():
    assert [f for f in range(1, 1025) if fold_served(f)] == [32, 64] + list(range(128, 1025, 128))


# ------------------------------------------------- the fold rounds, exactly


@pytest.mark.parametrize("fold", [32, 64, 256])
def test_fold_rounds_equal_jax(fold):
    """fold_rounds on a packed matrix (distinct values per row, -1 holes)
    equals _v7_fold_rounds bit for bit."""
    rng = np.random.default_rng(fold)
    R, C, k = 12, 512, 20
    keys = rng.integers(0, 50, (R, C)).astype(np.float32)
    packed = keys * 512.0 + np.arange(C, dtype=np.float32)
    packed[rng.random((R, C)) < 0.3] = -1.0
    packed[3] = -1.0
    want = np.asarray(jpg._v7_fold_rounds(jnp.asarray(packed), k, fold))
    np.testing.assert_array_equal(fold_rounds(_t(packed), k, fold).numpy(), want)


def _integer_group(C, D, seed):
    """A group whose products are small integers, exact in f32 in any order:
    (gp, gsize, qg [1, 8, D], codes [1, C, D], norms [1, C])."""
    rng = np.random.default_rng(seed)
    qg = rng.integers(-3, 4, (1, 8, D)).astype(np.float32)
    codes = rng.integers(-3, 4, (1, C, D)).astype(np.float32)
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return np.zeros(1, np.int32), np.array([C - 37], np.int32), qg, codes, norms


@pytest.mark.parametrize("fold", [32, 64, 256])
def test_k1_plain_fold_equals_jax_rounds(fold):
    """K1's plain version at a fold: _v7_fold_rounds of the packed keys
    (pallas_grouped.py::_v8_kernel's quantize, computed here in numpy)."""
    C, D, kk = 512, 16, 12
    gp, gsize, qg, codes, norms = _integer_group(C, D, fold)
    slot_mult, levels = packed_params(C)
    normsT = norms + 0.5
    got = grouped_scan_plain(_t(gp), _t(gsize), _t(qg), _t(codes), _t(normsT), kk, slot_mult,
                             levels, fold)
    prod = qg[0] @ codes[0].T
    key = np.clip(np.floor(prod - normsT[0][None, :]), 0, levels)
    lane = np.arange(C, dtype=np.float32)
    packed = np.where(lane[None, :] < gsize[0], key * slot_mult + lane, -1.0).astype(np.float32)
    want = np.asarray(jpg._v7_fold_rounds(jnp.asarray(packed), kk, fold))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("fold", [32, 64, 256])
def test_k5_plain_fold_equals_jax_select(fold):
    """K5's plain version at a fold: pallas_grouped.py::_v7_select of the
    same scores. Inner products (metric "ip") of unit queries with integer
    columns in [0, 127], both ends taken: each row's range is 127 and its
    scale levels / 127 = 258 an integer, so every key is exact in any order
    of operations."""
    C, D, kk = 512, 16, 12
    rng = np.random.default_rng(fold)
    qg = np.eye(8, D, dtype=np.float32)[None]
    codes = rng.integers(0, 128, (1, C, D)).astype(np.float32)
    codes[0, 0, :8], codes[0, 1, :8] = 0.0, 127.0
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    gp, gsize = np.zeros(1, np.int32), np.array([C - 37], np.int32)
    slot_mult, levels = packed_params(C)
    assert levels % 127 == 0
    out, stats = grouped_family.rowscale_scan(_t(gp), _t(gsize), _t(qg), _t(codes), _t(norms),
                                              kk, slot_mult, levels, "ip", "fold", fold=fold)
    scores = qg[0] @ codes[0].T
    valid = np.arange(C)[None, :] < gsize[0]
    w_out, w_stats = jpg._v7_select(jnp.asarray(scores), jnp.asarray(np.broadcast_to(
        valid, scores.shape)), kk, slot_mult, levels, fold)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(stats[0].numpy(), np.asarray(w_stats))


# The fold schedule of the CUDA bodies (csrc/common.cuh), in Python.


def _next_fold_segment(s, nseg, m):
    if s + m < nseg:
        return s + m
    b = s % m + 1
    return b if b < m and b < nseg else -1


def _fold_order_segment(i, nseg, m):
    for b in range(min(m, nseg)):
        cnt = (nseg - 1 - b) // m + 1
        if i < cnt:
            return b + i * m
        i -= cnt
    return -1


def _kernel_schedule(packed, k, fold):
    """What K1 and K5 compute at a fold: segments of 128 lanes in fold-block
    order, one 128-column top-2 state a block, the columns narrowed to F at
    F = 32 and 64, and each block's k rounds over its columns and the list of
    the blocks before it."""
    R, C = packed.shape
    m = fold // FOLD if fold > FOLD else 1
    nseg = C // FOLD
    out = np.full((R, k), -1.0, np.float32)
    order = [0]
    while (s := _next_fold_segment(order[-1], nseg, m)) >= 0:
        order.append(s)
    assert sorted(order) == list(range(nseg))
    assert order == [_fold_order_segment(i, nseg, m) for i in range(nseg)]
    for r in range(R):
        lst = []
        for b in range(min(m, nseg)):
            m1 = np.full(FOLD, -1.0, np.float32)
            m2 = np.full(FOLD, -1.0, np.float32)
            for s in (t for t in order if t % m == b):
                seg = packed[r, s * FOLD:(s + 1) * FOLD]
                m2 = np.maximum(m2, np.minimum(m1, seg))
                m1 = np.maximum(m1, seg)
            if fold < FOLD:
                cols = np.stack([np.concatenate([m1[c::fold], m2[c::fold]]) for c in range(fold)])
                top = -np.sort(-cols, axis=1)
                m1, m2 = top[:, 0], top[:, 1]
            lst = sorted(list(m1) + list(m2) + lst, reverse=True)[:k]
        out[r, :len(lst)] = lst
    return out


@pytest.mark.parametrize("fold,C", [(32, 512), (64, 512), (128, 512), (256, 512), (384, 768),
                                    (512, 1536)])
def test_kernel_fold_schedule_equals_fold_rounds(fold, C):
    rng = np.random.default_rng(C + fold)
    keys = rng.integers(0, 40, (6, C)).astype(np.float32)
    packed = keys * float(C) + np.arange(C, dtype=np.float32)
    packed[rng.random((6, C)) < 0.4] = -1.0
    packed[2, 200:] = -1.0  # a row whose last segments hold nothing
    want = fold_rounds(_t(packed), 25, fold).numpy()
    np.testing.assert_array_equal(_kernel_schedule(packed, 25, fold), want)


# ------------------------------------------------------------ merge="xla"


def _pool(seed, B=16, nprobe=4, kk=10, C=256, P=12):
    rng = np.random.default_rng(seed)
    slot_mult, levels = packed_params(C)
    keys = rng.integers(0, 2000, (B, nprobe * kk)).astype(np.float32)
    slots = rng.integers(0, 200, (B, nprobe * kk)).astype(np.float32)
    m_packed = keys * slot_mult + slots
    m_packed[rng.random(m_packed.shape) < 0.2] = -1.0
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    return m_packed.astype(np.float32), pids, slot_mult, levels


@pytest.mark.parametrize("exact", [True, False])
def test_pool_tail_xla_merge(monkeypatch, exact):
    """pool_tail with merge="xla": the ids and scores of merge="pallas" (K2's
    plain version) and of pallas_grouped.py::_pool_tail(merge="xla"), and no
    call of the K2 wrapper."""
    P, C, D, k, kk = 12, 256, 8, 10, 10
    codes, ids, _, norms = _store(6, C, D, seed=21)
    codes, ids, norms = (np.concatenate([a, a]) for a in (codes, ids, norms))
    q = np.random.default_rng(22).standard_normal((16, D)).astype(np.float32)
    m_packed, pids, slot_mult, levels = _pool(23)
    gmin, ginv = np.float32(-40.0), np.float32(1000.0)
    arrays = (m_packed, pids, pids, codes, ids, norms, q)
    kw = dict(exact=exact, gmin=gmin, ginv=ginv)
    want = jax.jit(jpg._pool_tail, static_argnums=tuple(range(7, 13)),
                   static_argnames=("merge", "exact"))(
        *(jnp.asarray(a) for a in arrays), k, kk, "l2", slot_mult, levels, False, merge="xla",
        **kw)
    pallas = grouped_scan.pool_tail(*(_t(a) for a in arrays), k, kk, "l2", slot_mult, levels,
                                    merge="pallas", **kw)
    calls = []
    monkeypatch.setattr(grouped_scan, "merge_positions", lambda *a, **kw: calls.append(1))
    got = grouped_scan.pool_tail(*(_t(a) for a in arrays), k, kk, "l2", slot_mult, levels,
                                 merge="xla", **kw)
    assert calls == []
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="merge must be"):
        grouped_scan.pool_tail(*(_t(a) for a in arrays), k, kk, "l2", slot_mult, levels,
                               merge="sort", **kw)


def test_xla_positions_equal_k2s():
    """The merge="xla" positions (merge_positions_plain) equal the JAX
    kernel merge's (_merge_positions_pallas in interpret mode) and the JAX
    XLA merge's inputs give the same winners: fold 128, kfin rounds."""
    m_packed, _, slot_mult, _ = _pool(24, B=40, nprobe=16)
    pool = m_packed.shape[1]
    poolp = -(-pool // 128) * 128
    keys = np.where(m_packed >= 0, np.floor(m_packed / slot_mult), -1.0).astype(np.float32)
    mk = np.pad(keys, ((0, 0), (0, poolp - pool)), constant_values=-1.0)
    want = np.asarray(jpg._merge_positions_pallas(jnp.asarray(mk), 10, poolp, 128,
                                                  interpret=True))
    got = grouped_scan.merge_positions_plain(_t(m_packed), 10, slot_mult)
    np.testing.assert_array_equal(got.numpy(), want)


def test_global_epilogue_xla_merge():
    """v8 (global_epilogue) with merge="xla" against its merge="pallas" and
    the JAX v8 with merge="xla": the same ids and scores."""
    P, C, D, k = 6, 256, 8, 10
    codes, ids, sizes, norms = _store(P, C, D, seed=31)
    q, pids = _queries(24, D, P, 3, seed=32)
    arrays = (codes, ids, sizes, norms, q, pids)
    want = jpg.grouped_scan_pallas_v8(*(jnp.asarray(a) for a in arrays), k, "l2", qt=8, gpb=2,
                                      merge="xla", interpret=True)
    pallas = grouped_family.grouped_scan_v8(*(_t(a) for a in arrays), k, "l2", qt=8, gpb=2)
    got = grouped_family.grouped_scan_v8(*(_t(a) for a in arrays), k, "l2", qt=8, gpb=2,
                                         merge="xla")
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    _assert_parity(want, got)


# ------------------------------------------------- profile_scan_latency


def test_profile_scan_latency_on_the_cpu():
    est = ListScanLatencyEstimator(d=16, n_values=[64, 9000], k_values=[1, 8], n_trials=2)
    est.profile_scan_latency(device="cpu")
    assert est.latency_grid.shape == (2, 2) and est.grid_source == "profiled"
    assert np.isfinite(est.latency_grid).all() and (est.latency_grid > 0).all()


@pytest.mark.parametrize("n,k", [(64, 16), (9000, 4)])
def test_flat_scan_at_grid_points_matches_jax(n, k):
    """What profile_scan_latency times at a grid point, kk = min(k, n) of one
    query against n rows (9000 > chunk_size: the chunked path), equals the
    JAX flat_scan's on the same numpy data."""
    rng = np.random.default_rng(n)
    codes = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    kk = min(k, n)
    ws, wi = jax_flat_scan(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(ids), kk, "l2")
    gs, gi = flat_scan(_t(q), _t(codes), _t(ids), kk, "l2")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("profile", ["profile_scan_latency", "profile_grouped_latency"])
def test_profiles_need_a_card_unless_asked_for_the_cpu(monkeypatch, profile):
    """An estimator without a device profiles on the CUDA card and raises
    where there is none: neither profile runs on the CPU unasked. The
    estimator's own device is the default of both."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est = ListScanLatencyEstimator(d=8, n_values=[64], k_values=[1], n_trials=1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        getattr(est, profile)()
    assert est.grid_source == "analytic"
    own = ListScanLatencyEstimator(d=8, n_values=[64], k_values=[1], n_trials=1, device="cpu")
    kw = dict(kernel="xla", n_queries=16) if profile == "profile_grouped_latency" else {}
    getattr(own, profile)(**kw)
    assert own.grid_source == "profiled"
