"""quake_tpu_torch ops against the JAX package on the same inputs (CPU).

The JAX side runs its Pallas kernels in interpret mode; the torch side runs
the plain PyTorch versions of kernels K1-K3 (the wrappers take them for CPU
tensors). Inputs come from numpy seeds and go to both packages as numpy.

Tolerances: grouping and the pool merge are integer arithmetic and must be
equal. The grouped scan and the parent ranking quantize f32 dot products
with floor(), so a different order of summation can move a key by one level
and swap a tie at the top-k boundary: those compare id overlap (>= 0.99)
and the exact distances of common ids (rtol = atol = 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops.grouped import build_groups_budget as jax_build_groups_budget
from quake_tpu.ops.grouped import build_groups_scatter as jax_build_groups_scatter
from quake_tpu.ops.pallas_flat import flat_topk_pallas, parent_rank_pallas
from quake_tpu.ops.pallas_grouped import (_global_bounds, _merge_positions_pallas,
                                          grouped_scan_pallas_v11)
from quake_tpu.ops.scan import merge_topk as jax_merge_topk
from quake_tpu.ops.scan import scores_to_distances as jax_scores_to_distances
from quake_tpu_torch.ops.flat_topk import flat_topk, parent_bias, parent_rank
from quake_tpu_torch.ops.grouped import build_groups_scatter, group_layout
from quake_tpu_torch.ops.grouped_scan import (fold_rounds, group_tables_plain,
                                              grouped_scan_v11, merge_positions,
                                              packed_params)
from quake_tpu_torch.ops.scan import merge_topk, scores_to_distances, topk_stable


def _t(a):
    return torch.from_numpy(np.array(a))


def _row_overlap(a, b):
    """Mean over rows of |set(a_row) & set(b_row)| / |set(b_row)| (-1 ignored)."""
    tot = 0.0
    for ra, rb in zip(a, b):
        sa, sb = set(ra[ra >= 0].tolist()), set(rb[rb >= 0].tolist())
        tot += len(sa & sb) / max(len(sb), 1) if sb else float(not sa)
    return tot / len(a)


@pytest.mark.parametrize("B,nprobe,P,qt,seed", [
    (12, 4, 8, 8, 0),
    (40, 6, 16, 16, 1),
    (64, 3, 128, 8, 2),
    (16384, 14, 160, 64, 3),  # the batch16k cells' probe lists
    (100, 14, 160, 64, 4),  # a churn query op's
])
def test_build_groups_scatter_matches_jax(B, nprobe, P, qt, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(-1, P, size=(B, nprobe)).astype(np.int32)
    pids[0, 1] = pids[0, 0]  # duplicate probe
    want = jax_build_groups_scatter(jnp.asarray(pids), P, qt)
    got = build_groups_scatter(_t(pids), P, qt)
    assert got[0].shape[0] == group_layout(B, nprobe, P, qt)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _jax_prologue(codes, sizes, norms, q, pids, metric, qt, gpb, n_bud):
    """The JAX package's prologue of grouped_scan_pallas_v11 (n_bud 0) and
    of grouped_scan_pallas_v10b (before its scatter placement's mask), as
    pallas_grouped.py writes it."""
    B, P, C = q.shape[0], codes.shape[0], codes.shape[1]
    levels = (1 << 24) // max(1 << (int(C - 1).bit_length()), 2) - 2
    qf = q.astype(jnp.float32)
    gmin, grange = _global_bounds(qf, codes, norms, sizes, metric, "analytic")
    ginv = float(levels) / grange
    q_coef = 2.0 * ginv if metric == "l2" else ginv
    normsT = ((norms if metric == "l2" else jnp.zeros_like(norms)) + gmin) * ginv
    if n_bud:
        group_pid, qlist, tgt = jax_build_groups_budget(pids, P, qt, n_bud)
    else:
        group_pid, qlist, tgt = jax_build_groups_scatter(pids, P, qt)
    G = group_pid.shape[0]
    Gn = -(-G // gpb) * gpb
    gp = jnp.pad(group_pid, (0, Gn - G), constant_values=-1)
    ql = jnp.pad(qlist, ((0, Gn - G), (0, 0)), constant_values=-1)
    tgt = jnp.pad(tgt, ((0, Gn - G), (0, 0)), constant_values=B * pids.shape[1])
    group_size = jnp.where(gp >= 0, sizes[jnp.maximum(gp, 0)], 0).astype(jnp.int32)
    qg = (qf * q_coef).astype(codes.dtype)[jnp.where(ql >= 0, ql, 0)]
    return dict(gp=gp, group_size=group_size, qg=qg, normsT=normsT, tgt=tgt, gmin=gmin,
                ginv=ginv)


@pytest.mark.parametrize("B,M,P,dtype,n_bud,metric", [
    (16384, 14, 160, "float32", 0, "l2"),  # sift1m-f32.batch16k
    (16384, 14, 160, "bfloat16", 0, "l2"),  # sift1m-bf16.batch16k
    (4096, 24, 1024, "float32", 65536, "l2"),  # sift1m-f32-nl1024-aps.oneshot4k
    (100, 14, 160, "float32", 0, "ip"),  # a churn query op
])
def test_group_tables_plain_matches_jax_prologue(B, M, P, dtype, n_bud, metric):
    """The plain grouping prologue (group_tables_plain, the CPU twin of the
    grouping kernels) at the cells' shapes against the JAX package's: the
    tables (gp, group_size, tgt) equal; the key scale and the scaled
    queries and norms within a few f32 ulps (the two packages sum |q|^2 in
    another order, so max |q|^2 can differ in its last place; PyTorch's
    levels / grange is a reciprocal times levels), the bf16 query tiles
    within one bf16 step. D and C are cut to 16 and 64: neither shapes a
    table."""
    rng = np.random.default_rng(B + P)
    D, C = 16, 64
    pids = np.stack([rng.choice(P, M, replace=False) for _ in range(B)]).astype(np.int32)
    if n_bud:
        depth = rng.integers(1, M + 1, B)
        pids[np.arange(M)[None, :] >= depth[:, None]] = -1
        assert int((pids >= 0).sum()) <= n_bud < B * M
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    sizes = rng.integers(0, C + 1, P).astype(np.int32)
    norms = (codes * codes).sum(-1) * (np.arange(C)[None, :] < sizes[:, None])
    q = (rng.standard_normal((B, D)) * 3.0).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = group_tables_plain(_t(codes).to(tdt), _t(sizes), _t(norms), _t(q), _t(pids), metric,
                             64, 4, packed_params(C)[1], "analytic", n_bud)
    want = _jax_prologue(jnp.asarray(codes).astype(getattr(jnp, dtype)), jnp.asarray(sizes),
                         jnp.asarray(norms), jnp.asarray(q), jnp.asarray(pids), metric, 64, 4,
                         n_bud)
    for key in ("gp", "group_size", "tgt"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("gmin", "ginv", "normsT"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)
    np.testing.assert_allclose(got["qg"].float().numpy(), np.asarray(want["qg"]).astype(np.float32),
                               rtol=1e-6 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("poolp,kfin", [(128, 10), (256, 10), (384, 20), (90, 10), (200, 10)])
def test_merge_positions_matches_pallas(poolp, kfin):
    """K2 takes the placed pool as it is (any width, packed key*slot_mult +
    slot values); the JAX package derives the keys, pads them to a 128
    multiple and merges them with _merge_positions_pallas (_pool_tail)."""
    rng = np.random.default_rng(poolp)
    B, slot_mult = 40, 256
    keys = rng.integers(-1, 200, size=(B, poolp)).astype(np.float32)
    keys[rng.random((B, poolp)) < 0.3] = -1.0
    keys[3] = -1.0  # an empty row
    slots = rng.integers(0, slot_mult, size=(B, poolp)).astype(np.float32)
    m_packed = np.where(keys >= 0, keys * slot_mult + slots, -1.0).astype(np.float32)
    padded = -(-poolp // 128) * 128
    m_keys = jnp.where(m_packed >= 0.0, jnp.floor(m_packed / float(slot_mult)), -1.0)
    mk = jnp.pad(m_keys, ((0, 0), (0, padded - poolp)), constant_values=-1.0)
    want = np.asarray(_merge_positions_pallas(mk, kfin, padded, 128, interpret=True))
    got = merge_positions(_t(m_packed), kfin, slot_mult).numpy()
    np.testing.assert_array_equal(want, got)


def test_fold_rounds_two_winners_per_column():
    """At most two winners per fold column: the third of a column is skipped
    in favour of the next-ranked lane (the contract the kernels reproduce)."""
    packed = torch.full((1, 256), -1.0)
    packed[0, 0], packed[0, 128] = 10 * 256 + 0.0, 9 * 256 + 128.0
    packed[0, 1] = 1 * 256 + 1.0
    out = fold_rounds(packed, 3)
    assert out.tolist() == [[2560.0, 2432.0, 257.0]]
    packed = torch.full((1, 384), -1.0)
    packed[0, 0], packed[0, 128], packed[0, 256] = 2560.0, 2432.0, 2304.0
    assert fold_rounds(packed, 3).tolist() == [[2560.0, 2432.0, -1.0]]


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_topk_matches_pallas(metric):
    rng = np.random.default_rng(3)
    N, D, B, k = 256, 16, 64, 8
    codes = rng.standard_normal((N, D)).astype(np.float32)
    ok = np.ones(N, bool)
    ok[200:] = False
    norms = (codes ** 2).sum(1)
    bias = np.where(ok, -norms if metric == "l2" else 0.0, -np.inf).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = np.asarray(flat_topk_pallas(jnp.asarray(codes), jnp.asarray(bias),
                                       jnp.asarray(q), k, metric, qt=8, interpret=True))
    got = flat_topk(_t(codes), _t(bias), _t(q), k, metric).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    assert _row_overlap(got, want) >= 0.99
    # Ranked: the first candidate is the true best where keys do not tie.
    assert np.mean(got[:, 0] == want[:, 0]) >= 0.95


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_parent_rank_matches_pallas(metric):
    rng = np.random.default_rng(10)
    Pp, Cp, D, B, nprobe = 2, 128, 16, 40, 8
    codes = rng.standard_normal((Pp, Cp, D)).astype(np.float32)
    ids = np.arange(Pp * Cp, dtype=np.int32).reshape(Pp, Cp)
    ids[1, 100:] = -1
    codes[1, 100:] = 10.0  # poison padding slots
    norms = (codes ** 2).sum(axis=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = np.asarray(parent_rank_pallas(jnp.asarray(codes), jnp.asarray(ids),
                                         jnp.asarray(norms), jnp.asarray(q), nprobe,
                                         metric, qt=8, interpret=True))
    got = parent_rank(_t(codes), _t(ids), _t(norms), _t(q), nprobe, metric).numpy()
    assert (got >= 0).all() and not np.isin(got, np.arange(228, 256)).any()
    assert _row_overlap(got, want) >= 0.99
    bias = parent_bias(_t(ids), _t(norms), metric).numpy()
    assert np.isneginf(bias[228:]).all() and np.isfinite(bias[:228]).all()


def _store(P, C, D, seed, sizes=None):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    sizes = np.full(P, C, np.int32) if sizes is None else np.asarray(sizes, np.int32)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0  # poison: must never be selected
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, sizes, norms


def _compare_grouped(codes, ids, sizes, norms, q, pids, k, metric, qt, gpb,
                     placement):
    s1, i1, n1 = grouped_scan_pallas_v11(
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(sizes), jnp.asarray(norms),
        jnp.asarray(q), jnp.asarray(pids), k, metric, qt=qt, gpb=gpb,
        interpret=True, placement=placement)
    s2, i2, n2 = grouped_scan_v11(_t(codes), _t(ids), _t(sizes), _t(norms), _t(q),
                                  _t(pids), k, metric, qt=qt, gpb=gpb,
                                  placement=placement)
    s1, i1 = np.asarray(s1), np.asarray(i1)
    s2, i2 = s2.numpy(), i2.numpy()
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    assert i2.dtype == np.int32 and s2.dtype == np.float32
    assert _row_overlap(i2, i1) >= 0.99
    for b in range(len(q)):  # exact distances of the ids both found
        common = set(i1[b][i1[b] >= 0].tolist()) & set(i2[b][i2[b] >= 0].tolist())
        for v in common:
            a = s1[b][i1[b] == v][0]
            c = s2[b][i2[b] == v][0]
            np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-4)
    d1 = np.asarray(jax_scores_to_distances(jnp.asarray(s1), jnp.asarray(i1), metric))
    d2 = scores_to_distances(_t(s1), _t(i1), metric).numpy()
    # XLA's CPU sqrt may differ from the correctly rounded one by an ulp.
    np.testing.assert_allclose(d2, d1, rtol=1e-6, atol=0)
    return i2


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("placement", ["sorted", "argsort"])
def test_grouped_scan_v11_matches_pallas(metric, placement):
    P, C, D, B, nprobe, k, qt = 8, 256, 16, 24, 4, 10, 8
    sizes = [256, 200, 0, 17, 256, 130, 256, 90]  # a ghost and partial fills
    codes, ids, sizes, norms = _store(P, C, D, seed=31, sizes=sizes)
    rng = np.random.default_rng(32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    i2 = _compare_grouped(codes, ids, sizes, norms, q, pids, k, metric, qt, 2, placement)
    for b in range(B):  # only resident vectors of probed partitions surface
        allowed = ids[pids[b]]
        got = i2[b][i2[b] >= 0]
        assert np.isin(got, allowed[allowed >= 0]).all()


def test_grouped_scan_v11_small_c_general_tail():
    """C = 128 with nprobe*kk > 128: the packed pool key no longer fits 24
    bits, so the tail ranks the pool with a top-k (the _rescore_topk
    branch) instead of kernel K2."""
    P, C, D, B, nprobe, k, qt = 16, 128, 16, 32, 16, 10, 16
    codes, ids, sizes, norms = _store(P, C, D, seed=5,
                                      sizes=np.random.default_rng(6).integers(60, 129, P))
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    levels, poolp = (1 << 24) // 128 - 2, 256
    assert levels * poolp + poolp >= 1 << 24
    _compare_grouped(codes, ids, sizes, norms, q, pids, k, "l2", qt, 4, "sorted")


def test_topk_stable_breaks_ties_low_index():
    v, i = topk_stable(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert i.tolist() == [[1, 2, 4]] and v.tolist() == [[3.0, 3.0, 3.0]]


def test_sorted_placement_key_overflow_raises():
    codes, ids, sizes, norms = _store(8, 128, 4, seed=0)
    q = torch.zeros((1 << 14, 4))
    pids = torch.zeros((1 << 14, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows uint32"):
        grouped_scan_v11(_t(codes), _t(ids), _t(sizes), _t(norms), q, pids, 5, "l2",
                         qt=8, gpb=1, placement="sorted")


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(12)
    sa = rng.standard_normal((20, 6)).astype(np.float32)
    sb = rng.standard_normal((20, 9)).astype(np.float32)
    sb[:, 5:] = -np.inf  # padding must surface as id -1
    ia = rng.permutation(1000)[:120].reshape(20, 6).astype(np.int32)
    ib = rng.permutation(1000)[:180].reshape(20, 9).astype(np.int32)
    want = jax_merge_topk(*(jnp.asarray(a) for a in (sa, ia, sb, ib)), 12)
    got = merge_topk(_t(sa), _t(ia), _t(sb), _t(ib), 12)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
