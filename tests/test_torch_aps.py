"""Recall-target search (APS) in the port against the JAX package, on the CPU.

What is held, and how closely:
  * the three APS cores (aps_loop, aps_plan, aps_oneshot) driven by one
    brute-force scan on integer-valued data (its scores exact in f32, so
    both frameworks see the same candidates): the masked pid matrices of
    the plan-based cores, their pair budgets and scanned counts. The recall
    profile is float32 arithmetic summed in another order, so a cumulative
    sum sitting at the target can move one plan: plans equal on >= 99% of
    the rows, and within plan_round ranks on the others; the loop's results
    equal on >= 99% of the rows;
  * build_groups_budget: equal to the JAX package's arrays;
  * the budgeted scan grouped_scan_v10b against grouped_scan_pallas_v10b
    (interpret mode) in both placements, exact and dequantized: row overlap
    >= 0.99, the dequantized scores of common ids within one key step; and
    against the port's own v10 on the same masked matrix;
  * QuakeIndex on a JAX index carried across (the kernel pinned to "xla"
    in both packages; the port's CPU default is v11, the JAX package's
    "xla"): calibrate_aps's fields (the radius model within 1e-4 relative),
    ids in every aps_mode (row overlap >= 0.99) with equal
    partitions_scanned, a saved JAX index served by the port;
  * mirrors of tests/test_aps.py on the port alone, with their tolerances:
    adherence, auto-mode selection, re-entry reset, the dense route; and the
    budget stage of calibrate_aps under v11 (the plain versions).
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu import coordinator as jc
from quake_tpu.geometry import beta_table as jax_beta_table
from quake_tpu.ops.grouped import build_groups_budget as jax_build_groups_budget
from quake_tpu.ops.pallas_grouped import grouped_scan_pallas_v10b
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy
from quake_tpu_torch import coordinator as tc
from quake_tpu_torch.convert import FIELDS
from quake_tpu_torch.geometry import beta_table
from quake_tpu_torch.ops.grouped import budget_layout, build_groups_budget
from quake_tpu_torch.ops.grouped_scan import (budget_sort_key_fits, global_bounds,
                                              grouped_scan_v10, grouped_scan_v10b, packed_params)
from quake_tpu_torch.utils import compute_recall, knn

APS_NAMES = ("aps_dimension", "aps_gamma", "aps_plan_width", "aps_oneshot_mcap", "aps_dense_w",
             "aps_calib_target", "aps_calib_nq", "aps_width_clip", "aps_budget_w")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These tests run many small torch ops (calibration, the host loop):
    two threads keep them from spinning against the other test processes'
    threads for the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _overlap(a, b, k):
    """Mean over rows of the share of b's distinct ids (>= 0) that a has (a
    row of a scan with a pid twice may hold an id twice); 1 where b has
    none and a none either. k: the row width, for the reader."""
    tot = 0.0
    for x, y in zip(a, b):
        sx, sy = {v for v in x.tolist() if v >= 0}, {v for v in y.tolist() if v >= 0}
        tot += len(sx & sy) / len(sy) if sy else float(not sx)
    return tot / len(b)


# ------------------------------------------------------------ the cores


def _core_inputs(seed, B=64, M=24, P=48, C=32, D=8):
    """Integer-valued codes and queries (exact f32 scores), clustered so
    that plans differ from query to query; candidates ranked by centroid
    distance."""
    rng = np.random.default_rng(seed)
    cents = rng.integers(-6, 7, (P, D)).astype(np.float32)
    codes = (cents[:, None, :] + rng.integers(-2, 3, (P, C, D))).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    ids[:, C - 3:] = -1  # partly filled partitions
    q = (cents[rng.integers(0, P, B)] + rng.integers(-3, 4, (B, D))).astype(np.float32)
    d2 = ((q[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    pids = np.argsort(d2, axis=1, kind="stable")[:, :M].astype(np.int32)
    pids[::7, M - 2:] = -1  # padded candidate rows
    return cents, codes, ids, q, pids


@functools.partial(jax.jit, static_argnames="k")
def _jax_brute(cj, ij, qj, eff, k):
    from quake_tpu.ops.scan import topk_from_scores

    ok = eff >= 0
    e = jnp.maximum(eff, 0)
    vec, vid = cj[e], ij[e]  # [B, W, C, D], [B, W, C]
    s = 2.0 * jnp.einsum("bwcd,bd->bwc", vec, qj) - (vec * vec).sum(-1) \
        - (qj * qj).sum(-1)[:, None, None]
    good = ok[:, :, None] & (vid >= 0)
    s = jnp.where(good, s, -jnp.inf).reshape(qj.shape[0], -1)
    vid = jnp.where(good, vid, -1).reshape(qj.shape[0], -1)
    return topk_from_scores(s, vid, k)


def _jax_scan(codes, ids, q, k, rec):
    cj, ij, qj = jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(q)

    def scan(eff, pair_budget=0):
        if rec is not None:  # the loop's scan is traced: nothing to record
            rec.append((np.asarray(eff), pair_budget))
        return _jax_brute(cj, ij, qj, eff, k)
    return scan


def _torch_scan(codes, ids, q, k, rec):
    ct, it, qt = torch.from_numpy(codes), torch.from_numpy(ids), torch.from_numpy(q)

    def scan(eff, pair_budget=0):
        rec.append((eff.numpy().copy(), pair_budget))
        ok = eff >= 0
        e = torch.clamp(eff, min=0).long()
        vec, vid = ct[e], it[e]
        s = 2.0 * torch.einsum("bwcd,bd->bwc", vec, qt) - (vec * vec).sum(-1) \
            - (qt * qt).sum(-1)[:, None, None]
        good = ok[:, :, None] & (vid >= 0)
        s = torch.where(good, s, torch.full_like(s, float("-inf"))).reshape(q.shape[0], -1)
        vid = torch.where(good, vid, torch.full_like(vid, -1)).reshape(q.shape[0], -1)
        from quake_tpu_torch.ops.scan import topk_from_scores
        return topk_from_scores(s, vid, k)
    return scan


def _setups(cents, q, pids, dim):
    bj = jc.aps_setup(jnp.asarray(q), jnp.asarray(cents), jnp.asarray(pids), dim, True, None)
    bt = tc.aps_setup(torch.from_numpy(q), torch.from_numpy(cents), torch.from_numpy(pids), dim,
                      True, None)
    np.testing.assert_allclose(bt[0].numpy(), np.asarray(bj[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bt[1].numpy(), np.asarray(bj[1]))
    return bj, bt


def _plans_agree(rec_j, rec_t, plan_round=4):
    assert len(rec_j) == len(rec_t)
    for (ej, bj), (et, bt) in zip(rec_j, rec_t):
        assert bj == bt and ej.shape == et.shape
        same = (ej == et).all(axis=1)
        assert same.mean() >= 0.99, same.mean()
        nj, nt = (ej >= 0).sum(1), (et >= 0).sum(1)
        assert np.abs(nj - nt).max() <= plan_round


@pytest.mark.parametrize("budget", [(0, 0), (10, 6), (24, 24)])
@pytest.mark.parametrize("core", ["plan", "oneshot"])
def test_plan_cores_match(core, budget):
    """aps_plan and aps_oneshot, with and without width_clip / budget_w
    (a tight budget that scales plans down, and one that holds them all),
    at the targets 0.8 and 0.95: the same masked pid matrices, pair budgets
    and scanned counts."""
    cents, codes, ids, q, pids = _core_inputs(3)
    k, dim, wclip, bw = 5, 8, *budget
    (bj, vj, tj), (bt, vt, tt) = _setups(cents, q, pids, dim)
    for target in (0.8, 0.95):
        rec_j, rec_t = [], []
        if core == "plan":
            sj, ij, cj = jc.aps_plan(jnp.asarray(q), jnp.asarray(pids), bj, vj, tj,
                                     jnp.float32(target), k, "l2", dim, 4, True,
                                     _jax_scan(codes, ids, q, k, rec_j), plan_margin=2,
                                     width_clip=wclip, budget_w=bw)
            st, it, ct = tc.aps_plan(torch.from_numpy(q), torch.from_numpy(pids), bt, vt, tt,
                                     target, k, "l2", dim, 4, True,
                                     _torch_scan(codes, ids, q, k, rec_t), plan_margin=2,
                                     width_clip=wclip, budget_w=bw)
        else:
            sj, ij, cj = jc.aps_oneshot(jnp.asarray(q), jnp.asarray(pids), bj, vj, tj,
                                        jnp.float32(target), k, "l2", dim, True,
                                        _jax_scan(codes, ids, q, k, rec_j), jnp.asarray(cents),
                                        jnp.float32(0.5), jnp.float32(0.9),
                                        width_clip=wclip, budget_w=bw)
            st, it, ct = tc.aps_oneshot(torch.from_numpy(q), torch.from_numpy(pids), bt, vt, tt,
                                        target, k, "l2", dim, True,
                                        _torch_scan(codes, ids, q, k, rec_t),
                                        torch.from_numpy(cents), 0.5, 0.9,
                                        width_clip=wclip, budget_w=bw)
        _plans_agree(rec_j, rec_t)
        if wclip:
            assert rec_t[-1][1] == q.shape[0] * max(bw, 4)
            assert (rec_t[-1][0] >= 0).sum() <= rec_t[-1][1]
        else:
            assert rec_t[-1][1] == 0
        same = (it.numpy() == np.asarray(ij)).all(1)
        assert same.mean() >= 0.99
        assert (ct.numpy() == np.asarray(cj)).mean() >= 0.99
        np.testing.assert_array_equal(ct.numpy(), sum((e >= 0).sum(1) for e, _ in rec_t))


@pytest.mark.parametrize("recompute", [0.0, 0.05])
def test_loop_core_matches(recompute):
    """aps_loop (the JAX package's lax.while_loop, a host loop here) with
    chunks of 4: the same results and scanned counts on >= 99% of the rows;
    the host loop ran its steps with one device read each after the first."""
    cents, codes, ids, q, pids = _core_inputs(5)
    k, dim = 5, 8
    (bj, vj, tj), (bt, vt, tt) = _setups(cents, q, pids, dim)
    for target in (0.7, 0.95):
        sj, ij, cj = jc.aps_loop(jnp.asarray(q), jnp.asarray(pids), bj, vj, tj,
                                 jnp.float32(target), jnp.float32(recompute), k, "l2", dim, 4,
                                 True, _jax_scan(codes, ids, q, k, None))
        rec, stats = [], {}
        st, it, ct = tc.aps_loop(torch.from_numpy(q), torch.from_numpy(pids), bt, vt, tt,
                                 target, recompute, k, "l2", dim, 4, True,
                                 _torch_scan(codes, ids, q, k, rec), stats=stats)
        assert ((it.numpy() == np.asarray(ij)).all(1)).mean() >= 0.99
        assert (ct.numpy() == np.asarray(cj)).mean() >= 0.99
        assert stats["steps"] == len(rec) and stats["syncs"] in (len(rec) - 1, len(rec))
        # Retired queries scan nothing more: their later rows are all -1.
        for (e0, _), (e1, _) in zip(rec, rec[1:]):
            assert ((e0 >= 0).any(1) | ~(e1 >= 0).any(1)).all()


# ------------------------------------------------------------- grouping


@pytest.mark.parametrize("P,B,M,qt,n_bud", [(32, 48, 12, 8, 200), (32, 48, 12, 8, 10_000),
                                             (7, 5, 3, 4, 9), (40_000, 1000, 60, 64, 5000),
                                             (1024, 4096, 24, 64, 65536), (1024, 4096, 24, 64, 150)])
def test_build_groups_budget_matches_jax(P, B, M, qt, n_bud):
    """The tables of build_groups_budget, with -1 pids, duplicate pids in a
    row and a budget below, at and far above the valid pairs; the fourth
    case takes the JAX package's two-operand sort branch ((P + 2) n >=
    2^31); the last two are the oneshot4k cell's shape (B=4096, 24
    candidates, nlist 1024) at its budget and far below the valid pairs."""
    rng = np.random.default_rng(P + B)
    base = np.stack([rng.choice(P, M, replace=False) for _ in range(B)])
    n_b = rng.integers(1, M + 1, B)
    pids = np.where(np.arange(M)[None, :] < n_b[:, None], base, -1).astype(np.int32)
    pids[::5, :2] = pids[::5, :1]
    n_valid = int((pids >= 0).sum())
    n_bud = max(n_bud, n_valid) if n_bud >= 200 else n_bud
    got = build_groups_budget(torch.from_numpy(pids), P, qt, n_bud)
    want = jax_build_groups_budget(jnp.asarray(pids), P, qt, n_bud)
    assert got[0].shape[0] == budget_layout(min(n_bud, B * M), P, qt)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------- v10b


def _masked_inputs(seed, ghosts=False, dup=False):
    rng = np.random.default_rng(seed)
    P, C, D, B, M = 32, 128, 16, 48, 12
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    sizes = rng.integers(C // 2, C + 1, P).astype(np.int32)
    if ghosts:
        sizes[3] = sizes[17] = 0
    for p in range(P):
        ids[p, sizes[p]:] = -1
    norms = (codes ** 2).sum(axis=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    base = np.stack([rng.choice(P, M, replace=False) for _ in range(B)])
    n_b = rng.integers(2, M + 1, B)
    pids = np.where(np.arange(M)[None, :] < n_b[:, None], base, -1).astype(np.int32)
    if dup:
        pids[::5, 1] = pids[::5, 0]
    return codes, ids, sizes, norms, q, pids


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("placement", ["scatter", "sorted"])
def test_v10b_matches_jax(placement, exact):
    """tests/test_pallas_grouped.py:830-920 on the port: grouped_scan_v10b
    against grouped_scan_pallas_v10b(interpret=True) with ghost partitions
    and duplicate pids, a generous and an exactly tight budget."""
    arrays = _masked_inputs(37, ghosts=True, dup=True)
    codes, ids, sizes, norms, q, pids = arrays
    k, qt = 5, 8
    n_valid = int((pids >= 0).sum())
    assert budget_sort_key_fits(q.shape[0], pids.shape[1], n_valid, codes.shape[0], qt, 2)
    _, grange = global_bounds(torch.from_numpy(q), torch.from_numpy(norms), "l2")
    step = float(grange) / packed_params(codes.shape[1])[1]
    for bud in (-(-n_valid // 8) * 8, n_valid):
        s_t, i_t, c_t = grouped_scan_v10b(*(torch.from_numpy(a) for a in arrays), k, "l2",
                                          pair_budget=bud, qt=qt, gpb=2, placement=placement,
                                          exact=exact)
        s_j, i_j, c_j = grouped_scan_pallas_v10b(*(jnp.asarray(a) for a in arrays), k, "l2",
                                                 pair_budget=bud, qt=qt, gpb=2, interpret=True,
                                                 placement=placement, exact=exact)
        i_j, s_j = np.asarray(i_j), np.asarray(s_j)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        assert _overlap(i_t.numpy(), i_j, k) >= 0.99
        for a, sa, b, sb in zip(i_t.numpy(), s_t.numpy(), i_j, s_j):
            theirs = dict(zip(b.tolist(), sb.tolist()))
            for i, s in zip(a.tolist(), sa.tolist()):
                if i >= 0 and i in theirs:
                    assert abs(s - theirs[i]) <= (step if not exact else 1e-4 * (1 + abs(s)))


@pytest.mark.parametrize("placement", ["scatter", "sorted"])
def test_v10b_equals_v10(placement):
    """The budgeted scan on a masked matrix is the port's v10 when the budget
    holds every valid pair, generous or exactly tight: scatter equal, sorted
    the same members (lane order differs; at most a quantization tie
    apart), both with the same scanned counts; K1's launches on the budget
    grid are counted apart."""
    from quake_tpu_torch import _ext

    arrays = tuple(torch.from_numpy(a) for a in _masked_inputs(31))
    pids = arrays[-1]
    n_valid = int((pids >= 0).sum())
    s0, i0, c0 = grouped_scan_v10(*arrays, 5, "l2", qt=8, gpb=2)
    for bud in (-(-n_valid // 8) * 8 + 64, n_valid):
        s1, i1, c1 = grouped_scan_v10b(*arrays, 5, "l2", pair_budget=bud, qt=8, gpb=2,
                                       placement=placement)
        torch.testing.assert_close(c1, c0, rtol=0, atol=0)
        if placement == "scatter":
            torch.testing.assert_close(i1, i0, rtol=0, atol=0)
            torch.testing.assert_close(s1, s0, rtol=0, atol=0)
        else:
            for a, b in zip(i1.tolist(), i0.tolist()):
                assert len(set(a) & set(b)) >= len(set(b)) - 1
    with pytest.raises(ValueError, match="placement"):
        grouped_scan_v10b(*arrays, 5, "l2", pair_budget=n_valid, placement="argsort")
    _ext.reset_launches()  # on the CPU the plain version runs: nothing is launched
    grouped_scan_v10b(*arrays, 5, "l2", pair_budget=n_valid, qt=8)
    assert not any(_ext.launches.values())


def test_dispatch_routes_the_budget():
    """coordinator.grouped_scan with pair_budget: masked v10 and v11 run
    v10b (v11 sorted where the key fits, as in the JAX package), xla and a
    dense request ignore it."""
    arrays = tuple(torch.from_numpy(a) for a in _masked_inputs(31))
    codes, ids, sizes, norms, q, pids = arrays
    n_valid = int((pids >= 0).sum())
    want = grouped_scan_v10b(*arrays, 5, "l2", pair_budget=n_valid, qt=8, gpb=4,
                             placement="sorted")
    got = tc.grouped_scan(codes, ids, sizes, norms, q, pids, 5, "l2", 8, 64, "v11",
                          pair_budget=n_valid)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got = tc.grouped_scan(codes, ids, sizes, norms, q, pids, 5, "l2", 8, 64, "v10g2",
                          pair_budget=n_valid)
    want = grouped_scan_v10b(*arrays, 5, "l2", pair_budget=n_valid, qt=8, gpb=2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    plain = tc.grouped_scan(codes, ids, sizes, norms, q, pids, 5, "l2", 8, 64, "xla")
    budgeted = tc.grouped_scan(codes, ids, sizes, norms, q, pids, 5, "l2", 8, 64, "xla",
                               pair_budget=n_valid)
    torch.testing.assert_close(plain[1], budgeted[1], rtol=0, atol=0)


# ------------------------------------------------- the index, both packages


def _corpus(n, d, n_centers, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * spread
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, n_centers, 1024)] + rng.standard_normal((1024, d)).astype(
        np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _carried(j):
    st = {f: np.asarray(getattr(j.store.state, f)) for f in FIELDS}
    pst = {f: np.asarray(getattr(j.parent.store.state, f)) for f in FIELDS}
    t = index_from_numpy(st, pst, j.metric, device="cpu")
    t.aps_dimension = j.aps_dimension
    return t


@pytest.fixture(scope="module")
def calibrated_pair():
    """A JAX index (8000 x 16, 48 partitions), saved and loaded so that its
    id map is rebuilt from the slots as the port's is (the calibration
    samples the map's first ids), carried across; each package calibrates
    its own copy under "xla"."""
    prev = os.environ.get("QUAKE_TPU_KERNEL")
    os.environ["QUAKE_TPU_KERNEL"] = "xla"
    try:
        x, q = _corpus(8000, 16, 40, seed=3)
        j0 = JaxIndex()
        j0.build(x, np.arange(len(x)), JaxBuildParams(nlist=48, calibrate_aps=False))
        with tempfile.TemporaryDirectory() as tmp:
            j0.save(tmp)
            j = JaxIndex()
            j.load(tmp)
        t = _carried(j)
        j.calibrate_aps()
        t.calibrate_aps()
    finally:
        if prev is None:
            os.environ.pop("QUAKE_TPU_KERNEL")
        else:
            os.environ["QUAKE_TPU_KERNEL"] = prev
    return j, t, x, q


def test_calibration_matches(calibrated_pair):
    j, t, _, _ = calibrated_pair
    for name in APS_NAMES:
        assert getattr(t, name) == getattr(j, name), name
    assert j.aps_radius_ab is not None and t.aps_radius_ab.shape == j.aps_radius_ab.shape
    np.testing.assert_allclose(t.aps_radius_ab, np.asarray(j.aps_radius_ab), rtol=1e-4,
                               atol=1e-4 * float(np.abs(j.aps_radius_ab).max()))
    assert t.aps_dense_w > 0 and t.aps_plan_width > 0  # the gates engaged


def _copy_calibration(src, dst):
    for name in APS_NAMES:
        setattr(dst, name, getattr(src, name))
    dst.aps_radius_ab = (None if src.aps_radius_ab is None
                         else np.asarray(src.aps_radius_ab, np.float32))


@pytest.mark.parametrize("mode,target,B", [
    ("auto", 0.9, 40), ("auto", 0.97, 1024), ("auto", 0.97, 40), ("dense", 0.9, 1024),
    ("dense", 0.97, 40), ("oneshot", 0.9, 1024), ("oneshot", 0.97, 40), ("planned", 0.9, 1024),
    ("planned", 0.97, 40), ("loop", 0.9, 1024), ("loop", 0.97, 40)])
def test_search_every_mode_matches(calibrated_pair, monkeypatch, mode, target, B):
    """Every aps_mode on the carried index with the JAX package's
    calibration, at the calibrated target (auto and dense take the dense
    prefix) and above it (auto plans per query: oneshot at B=1024, planned
    at B=40; dense raises in both packages): ids overlap >= 0.99 a row on
    average, partitions_scanned equal, the loop's steps and syncs reported;
    then with an explicit candidate fraction (no dense route, chunks of 4)."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    j, _, _, q = calibrated_pair
    t = _carried(j)
    _copy_calibration(j, t)
    kw = dict(k=10, recall_target=target, aps_mode=mode)
    if mode == "dense" and target > j.aps_calib_target:
        with pytest.raises(ValueError, match="aps_mode='dense'"):
            j.search(q[:B], JaxSearchParams(**kw))
        with pytest.raises(ValueError, match="aps_mode='dense' requires a calibrated width"):
            t.search(q[:B], SearchParams(**kw))
        return
    fracs = [None] if mode in ("auto", "dense") else [None, 0.25]
    for frac in fracs:
        kw.update(initial_search_fraction=frac)
        rj, rt = j.search(q[:B], JaxSearchParams(**kw)), t.search(q[:B], SearchParams(**kw))
        assert _overlap(rt.ids, rj.ids, 10) >= 0.99, (mode, target, B, frac)
        assert rt.timing_info.partitions_scanned == rj.timing_info.partitions_scanned
        assert np.isfinite(rt.distances[rt.ids >= 0]).all()
        if mode == "loop":
            assert rt.timing_info.aps_loop_steps >= 1
            assert rt.timing_info.aps_loop_syncs in (rt.timing_info.aps_loop_steps - 1,
                                                     rt.timing_info.aps_loop_steps)


def test_saved_jax_index_serves_aps(calibrated_pair, tmp_path, monkeypatch):
    """A JAX-calibrated index saved and loaded by the port keeps its
    calibration and serves APS with the JAX package's ids."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    j, _, _, q = calibrated_pair
    j.save(str(tmp_path / "idx"))
    t = QuakeIndex(device="cpu").load(str(tmp_path / "idx"))
    for name in APS_NAMES:
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.aps_radius_ab, np.asarray(j.aps_radius_ab))
    for mode in ("oneshot", "planned"):
        sp = dict(k=10, recall_target=0.95, aps_mode=mode)
        rj, rt = j.search(q, JaxSearchParams(**sp)), t.search(q, SearchParams(**sp))
        assert _overlap(rt.ids, rj.ids, 10) >= 0.99
        assert rt.timing_info.partitions_scanned == rj.timing_info.partitions_scanned


# ------------------------------------------------ mirrors, on the port alone


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_adherence_loop_and_planned(metric, monkeypatch):
    """tests/test_aps.py:118 and :163 on the scan those tests run on the CPU
    ("xla"; test_budget_stage_under_v11 and the card tests run v11):
    achieved recall >= target - 0.05 at 0.5 and 0.9; more scanning for a
    higher target; planned not below the loop by more than 0.1."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8000, 16)).astype(np.float32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    if metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=64, metric=metric, calibrate_aps=False))
    idx.calibrate_aps()
    gt, _ = knn(q, x, 10, metric)
    prev = 0
    for target in (0.5, 0.9):
        kw = dict(k=10, recall_target=target, initial_search_fraction=0.5,
                  recompute_threshold=0.0, aps_chunk_size=4)
        loop = idx.search(q, SearchParams(aps_mode="loop", **kw))
        planned = idx.search(q, SearchParams(aps_mode="planned", **kw))
        r_loop, r_plan = compute_recall(loop.ids, gt, 10), compute_recall(planned.ids, gt, 10)
        assert r_loop >= target - 0.05 and r_plan >= target - 0.05, (target, r_loop, r_plan)
        assert r_plan >= r_loop - 0.1
        assert loop.timing_info.partitions_scanned >= prev
        prev = loop.timing_info.partitions_scanned
        assert planned.timing_info.partitions_scanned <= 32


def test_adherence_oneshot_and_auto_mode(monkeypatch):
    """tests/test_aps.py:202 and :268, on the "xla" scan as there: oneshot
    adheres (target - 0.05); auto picks oneshot at B >= 1024 when the
    predictor is calibrated, else planned, and planned below 1024 queries
    (never the loop)."""
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    x, q = _corpus(10_000, 16, 32, seed=5, spread=4.0)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=32))  # >= 10,000 vectors: calibrates
    assert idx.aps_radius_ab is not None
    gt, _ = knn(q[:64], x, 10, "l2")
    res = idx.search(q[:64], SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5,
                                          aps_mode="oneshot"))
    assert compute_recall(res.ids, gt, 10) >= 0.85
    assert res.timing_info.partitions_scanned <= 16

    calls = {"oneshot": 0, "planned": 0, "loop": 0}
    for name, fn in (("oneshot", "aps_search_oneshot_fused"), ("planned", "aps_search_planned"),
                     ("loop", "aps_search")):
        real = getattr(tc, fn)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tc, fn, wrapped)
    sp = SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5)
    idx.search(q, sp)
    assert calls == {"oneshot": 1, "planned": 0, "loop": 0}
    idx.search(q[:16], sp)
    assert calls == {"oneshot": 1, "planned": 1, "loop": 0}
    idx.aps_radius_ab = None
    idx.search(q, sp)
    assert calls == {"oneshot": 1, "planned": 2, "loop": 0}


def test_calibrate_aps_reentry_resets_serving_fields():
    """tests/test_aps.py:356: a re-run that stops at its first gate (fewer
    than 512 vectors) leaves no earlier product serving."""
    x, _ = _corpus(4096, 16, 32, seed=3, spread=8.0)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=16, calibrate_aps=False))
    idx.aps_dense_w, idx.aps_width_clip, idx.aps_budget_w = 3, 6, 4
    idx.aps_calib_target, idx.aps_calib_nq = 0.9, 128
    idx.aps_radius_ab = np.ones((10, 2), np.float32)
    idx.remove(np.arange(4096 - 256))
    idx.calibrate_aps(target=0.9)
    for f in ("aps_dense_w", "aps_width_clip", "aps_budget_w", "aps_calib_nq",
              "aps_oneshot_mcap", "aps_plan_width"):
        assert getattr(idx, f) == 0, f
    assert idx.aps_calib_target == 0.0 and idx.aps_radius_ab is None and idx.aps_gamma == 1.0


def test_dense_prefix_routing():
    """tests/test_aps.py:662: auto and dense serve the calibrated width as a
    fixed-nprobe search; the masked modes, an explicit fraction and a
    target above the calibrated one do not; dense without a route raises."""
    x, q = _corpus(8000, 16, 32, seed=23, spread=3.0)
    q = q[:32]
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=32, calibrate_aps=False))
    idx.aps_dense_w, idx.aps_width_clip, idx.aps_budget_w = 6, 0, 0
    idx.aps_calib_target = 0.9
    fixed = idx.search(q, SearchParams(k=10, nprobe=6))
    for mode in ("auto", "dense"):
        res = idx.search(q, SearchParams(k=10, recall_target=0.9, aps_mode=mode))
        np.testing.assert_array_equal(res.ids, fixed.ids)
        assert res.timing_info.partitions_scanned == 6
    assert idx.search(q, SearchParams(k=10, recall_target=0.9,
                                      aps_mode="loop")).ids.shape == (32, 10)
    frac = idx.search(q, SearchParams(k=10, recall_target=0.9, initial_search_fraction=2 / 32))
    assert frac.timing_info.partitions_scanned <= 2
    assert idx.search(q, SearchParams(k=10, recall_target=0.97)).timing_info.partitions_scanned > 6
    idx.aps_dense_w, idx.aps_width_clip = 0, 6
    np.testing.assert_array_equal(
        idx.search(q, SearchParams(k=10, recall_target=0.9)).ids, fixed.ids)
    idx.aps_width_clip = idx.aps_calib_target = 0
    with pytest.raises(ValueError, match="aps_mode='dense' requires a calibrated width"):
        idx.search(q, SearchParams(k=10, recall_target=0.9, aps_mode="dense"))


def test_budget_stage_under_v11(monkeypatch):
    """calibrate_aps's budget stage, which the JAX package runs only on its
    Pallas scans: under the port's v11 (the plain versions here) it sets
    width_clip and budget_w, the oneshot search then runs grouped_scan_v10b
    with a pair budget and serves at the target - 0.03, and every mode
    serves with exact_distances=False too (ids as the exact mode's on >=
    0.99 of each row, on average)."""
    monkeypatch.delenv("QUAKE_TPU_KERNEL", raising=False)
    x, q = _corpus(6000, 16, 48, seed=11, spread=2.0)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=48, calibrate_aps=False))
    assert idx._grouped_kernel().startswith("v11")
    idx.calibrate_aps()
    assert idx.aps_width_clip > 0 and idx.aps_budget_w > 0
    assert idx.aps_budget_w <= idx.aps_width_clip
    seen = []
    real = tc.grouped_scan_v10b

    def spy(*a, **kw):
        seen.append((kw["pair_budget"], kw["placement"]))
        return real(*a, **kw)
    monkeypatch.setattr(tc, "grouped_scan_v10b", spy)
    gt, _ = knn(q, x, 10, "l2")
    for mode in ("oneshot", "planned"):
        sp = dict(k=10, recall_target=0.9, aps_mode=mode)
        res = idx.search(q, SearchParams(**sp))
        assert compute_recall(res.ids, gt, 10) >= 0.9 - 0.03, mode
        inexact = idx.search(q, SearchParams(exact_distances=False, **sp))
        assert _overlap(inexact.ids, res.ids, 10) >= 0.99
    assert seen and all(b == 1024 * idx.aps_budget_w for b, _ in seen)


@pytest.mark.parametrize("small_batch", [False, True])
def test_aps_search_entry_point_matches(small_batch):
    """coordinator.aps_search, partition-major ("xla" in both packages) and
    query-major (small_batch=True: ivf_scan, the JAX package's opt-in
    knob), on one store with the beta table of a swept dimension and a
    gamma, as calibrate_aps drives it: ids overlap >= 0.99 a row, scanned
    counts equal on >= 99% of the rows."""
    codes, ids, sizes, norms, q, _ = _masked_inputs(53)
    cents = codes.mean(axis=1)
    d2 = ((q[:, None, :] - cents[None]) ** 2).sum(-1)
    pids = np.argsort(d2, axis=1, kind="stable")[:, :16].astype(np.int32)
    table_dim = 6  # a swept model dimension, not the scan's
    kw = dict(k=5, metric="l2", dimension=16, chunk=4, qt=8, kernel="xla",
              small_batch=small_batch)
    sj, ij, cj = jc.aps_search(*(jnp.asarray(a) for a in (codes, ids, cents, q, pids)),
                               jnp.float32(0.9), jnp.float32(0.0),
                               table=jax_beta_table(table_dim, "l2"), sizes=jnp.asarray(sizes),
                               norms=jnp.asarray(norms), gamma=jnp.float32(2.0), **kw)
    stats = {}
    st, it, ct = tc.aps_search(*(torch.from_numpy(a) for a in (codes, ids, cents, q, pids)),
                               0.9, 0.0, table=beta_table(table_dim, "l2"),
                               sizes=torch.from_numpy(sizes), norms=torch.from_numpy(norms),
                               gamma=2.0, stats=stats, **kw)
    assert _overlap(it.numpy(), np.asarray(ij), 5) >= 0.99
    assert (ct.numpy() == np.asarray(cj)).mean() >= 0.99
    assert 1 <= stats["steps"] <= 4
