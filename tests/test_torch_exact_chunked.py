"""The exact-score scans (v2, v3), the size-aware chunked scans (v4, v5, v6),
the scan in plain tensor operations ("xla") and their dispatch, quake_tpu_torch
against the JAX package on the same inputs (CPU).

The JAX side runs its Pallas kernels in interpret mode; the torch side runs
the plain PyTorch versions of kernels K4, K6 and K7 (the wrappers take them
for CPU tensors). Inputs come from numpy seeds and go to both packages as
numpy.

Tolerances: grouping is integer arithmetic and must be equal. The exact
scans select on f32 scores: scores within rtol = atol = 1e-5 (one f32 dot
product summed in another order), ids equal wherever a row's scores are
distinct. The chunked scans quantize with floor(), so another order of
summation can move a key by one level and swap a near-tie at the top-k
boundary: id overlap >= 0.99 and the exact distances of common ids within
rtol = atol = 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops.grouped import _merge_groups as jax_merge_groups
from quake_tpu.ops.grouped import build_chunk_groups as jax_build_chunk_groups
from quake_tpu.ops.grouped import grouped_scan_xla as jax_scan_xla
from quake_tpu.ops.pallas_grouped import (_v3p_group_body, grouped_scan_pallas,
                                          grouped_scan_pallas_v3, grouped_scan_pallas_v4,
                                          grouped_scan_pallas_v5, grouped_scan_pallas_v6)
from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu_torch import coordinator
from quake_tpu_torch.ops import grouped_chunked, grouped_exact, grouped_family
from quake_tpu_torch.ops.grouped import (build_chunk_groups, grouped_scan_xla, merge_groups)
from quake_tpu_torch.ops.grouped_scan import packed_params
from test_torch_spill_ops import assert_no_dups, assert_scan_parity, queries, spilled_store


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _row_overlap(a, b):
    """Mean over rows of |set(a_row) & set(b_row)| / |set(b_row)| (-1 ignored)."""
    tot = 0.0
    for ra, rb in zip(a, b):
        sa, sb = set(ra[ra >= 0].tolist()), set(rb[rb >= 0].tolist())
        tot += len(sa & sb) / max(len(sb), 1) if sb else float(not sa)
    return tot / len(a)


def _store(P, C, D, seed, sizes):
    """Compact-prefix store with shuffled ids (so slot order and id order
    differ) and poisoned padding that must never be selected."""
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = rng.permutation(P * C).astype(np.int32).reshape(P, C)
    sizes = np.asarray(sizes, np.int32)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, sizes, norms


def _sizes(P, C):
    """Uneven sizes: full, partial, empty, below kk, one vector, ..."""
    base = [C, C - 56, 0, 5, C, C // 2, 1, 90, C - 1, 130, C, 17]
    return (base * (P // len(base) + 1))[:P]


def _queries(B, D, P, nprobe, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    pids[3, 2] = -1
    pids[5, :] = -1  # a query with no probe
    return q, pids


def _assert_exact_match(s1, i1, s2, i2):
    """Scores close; ids equal at every rank whose score differs from its
    neighbours' by more than the tolerance (a tie may order either way)."""
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-5)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(s1, axis=1))
    gap = np.where(np.isnan(gap), 0.0, gap)  # -inf next to -inf
    tol = 1e-4 * (1.0 + np.abs(s1))
    clear = np.ones_like(s1, bool)
    clear[:, 1:] &= gap > tol[:, 1:]
    clear[:, :-1] &= gap > tol[:, :-1]
    np.testing.assert_array_equal(i2[clear], i1[clear])
    assert (i2[np.isneginf(s2)] == -1).all()


def _assert_rescored_match(s1, i1, s2, i2, ids, pids):
    assert _row_overlap(i2, i1) >= 0.99
    for b in range(len(i1)):
        common = set(i1[b][i1[b] >= 0].tolist()) & set(i2[b][i2[b] >= 0].tolist())
        for v in common:
            np.testing.assert_allclose(s2[b][i2[b] == v][0], s1[b][i1[b] == v][0],
                                       rtol=1e-4, atol=1e-4)
        allowed = ids[pids[b][pids[b] >= 0]]
        assert np.isin(i2[b][i2[b] >= 0], allowed[allowed >= 0]).all()
        assert np.isneginf(s2[b][i2[b] < 0]).all()


# ------------------------------------------------------------------ grouping


@pytest.mark.parametrize("B,nprobe,P,qt,ct,cap,seed", [
    (12, 4, 8, 8, 128, 256, 0),
    (40, 3, 16, 16, 128, 384, 1),
    (33, 5, 12, 32, 64, 200, 2),  # cap % ct != 0: the last chunk is partial
    (20, 4, 16, 8, 256, 256, 3),  # one chunk a partition
])
def test_build_chunk_groups_matches_jax(B, nprobe, P, qt, ct, cap, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(-1, P, size=(B, nprobe)).astype(np.int32)
    pids[0, 1] = pids[0, 0]
    pids[1, :] = -1
    sizes = np.asarray(_sizes(P, cap), np.int32)
    sizes[-1] = cap
    want = jax_build_chunk_groups(*_j(pids, sizes), P, qt, ct, cap)
    got = build_chunk_groups(_t(pids), _t(sizes), P, qt, ct, cap)
    assert len(got) == len(want) == 7
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    cg_pid, cg_chunk, cg_qsrc, cg_size = (g.numpy() for g in got[:4])
    live = cg_pid >= 0
    assert (np.diff(live.astype(int)) <= 0).all()  # a compact prefix
    assert (cg_size[live] > 0).all() and (cg_size[~live] == 0).all()
    np.testing.assert_array_equal(cg_size[live],
                                  np.clip(sizes[cg_pid[live]] - cg_chunk[live] * ct, 0, ct))


# ------------------------------------------------- merge_groups and "xla"


@pytest.mark.parametrize("k,kk", [(5, 5), (10, 4), (30, 6)])
def test_merge_groups_matches_jax(k, kk):
    rng = np.random.default_rng(k)
    G, qt, B, nprobe = 9, 8, 20, 4
    g_scores = -np.sort(rng.random((G, qt, kk)).astype(np.float32), axis=2)
    g_ids = rng.integers(0, 1000, (G, qt, kk)).astype(np.int32)
    g_scores[:, :, -1] = -np.inf
    g_ids[:, :, -1] = -1
    pair_group = rng.integers(-1, G, (B, nprobe)).astype(np.int32)
    pair_slot = rng.integers(0, qt, (B, nprobe)).astype(np.int32)
    pids = np.where(pair_group >= 0, 1, -1).astype(np.int32)
    want = jax_merge_groups(*_j(g_scores, g_ids, pair_group, pair_slot, pids), k, kk)
    got = merge_groups(*(_t(a) for a in (g_scores, g_ids, pair_group, pair_slot, pids)), k, kk)
    assert got[0].shape == (B, k) and got[1].dtype == torch.int32
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # dedup (a spilled store): the ids repeat across groups here, and each
    # row keeps an id once, as in the JAX package.
    want = jax_merge_groups(*_j(g_scores, g_ids, pair_group, pair_slot, pids), k, kk, dedup=True)
    got = merge_groups(*(_t(a) for a in (g_scores, g_ids, pair_group, pair_slot, pids)), k, kk,
                       dedup=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert_no_dups(got[1].numpy())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("C,with_norms,k", [(256, True, 10), (200, False, 10), (200, True, 300)])
def test_grouped_scan_xla_matches_jax(C, with_norms, k, metric):
    P, D, B, nprobe, qt = 12, 16, 32, 4, 8
    codes, ids, sizes, norms = _store(P, C, D, seed=C, sizes=_sizes(P, C))
    q, pids = _queries(B, D, P, nprobe, seed=C + 1)
    s1, i1, n1 = jax_scan_xla(*_j(codes, ids, q, pids), k, metric, qt=qt, group_chunk=5,
                              norms=jnp.asarray(norms) if with_norms else None)
    s2, i2, n2 = grouped_scan_xla(*(_t(a) for a in (codes, ids, q, pids)), k, metric, qt=qt,
                                  group_chunk=5, norms=_t(norms) if with_norms else None)
    assert s2.shape == (B, k) and i2.dtype == torch.int32 and s2.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    _assert_exact_match(np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy())
    assert (i2.numpy()[5] == -1).all()


# ----------------------------------------------------------- kernel K6: v3, v2


def _run_exact(name, codes, ids, sizes, norms, q, pids, k, metric, qt):
    if name == "v3":
        want = grouped_scan_pallas_v3(*_j(codes, ids, sizes, norms, q, pids), k, metric, qt=qt,
                                      interpret=True)
        got = grouped_exact.grouped_scan_v3(*(_t(a) for a in (codes, ids, sizes, norms, q, pids)),
                                            k, metric, qt=qt)
    else:
        want = grouped_scan_pallas(*_j(codes, ids, q, pids), k, metric, qt=qt, interpret=True)
        got = grouped_exact.grouped_scan_v2(*(_t(a) for a in (codes, ids, q, pids)), k, metric,
                                            qt=qt)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name,C,k", [("v3", 256, 10), ("v3", 200, 10), ("v3", 200, 300),
                                      ("v2", 256, 10), ("v2", 200, 10), ("v2", 200, 1)])
def test_exact_wrappers_match_jax(name, C, k, metric):
    """exact_scan_plain, in mode slot (v3) and id (v2), through the wrappers
    against the JAX kernels in interpret mode: uneven sizes with an empty
    partition, a -1 pid, a query without probes, k > C."""
    P, D, B, nprobe, qt = 12, 16, 32, 4, 8
    codes, ids, sizes, norms = _store(P, C, D, seed=C + k, sizes=_sizes(P, C))
    if name == "v2":  # v2 reads the whole slab: the padding must be harmless
        codes = np.where((ids >= 0)[:, :, None], codes, 0.0).astype(np.float32)
    q, pids = _queries(B, D, P, nprobe, seed=k)
    (s1, i1, n1), (s2, i2, n2) = _run_exact(name, codes, ids, sizes, norms, q, pids, k, metric,
                                            qt)
    assert s2.shape == (B, k) and i2.dtype == np.int32 and s2.dtype == np.float32
    np.testing.assert_array_equal(n1, n2)
    _assert_exact_match(s1, i1, s2, i2)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", ["v3", "v2"])
def test_exact_tie_breaks_match_jax(name, metric):
    """Duplicate vectors score equally: v3 prefers the larger slot, v2 the
    larger id; with k = 1 only one of a pair survives, so the choice shows."""
    P, C, D, B, nprobe, qt = 4, 128, 16, 16, 2, 8
    codes, ids, sizes, norms = _store(P, C, D, seed=7, sizes=[C, 100, C, 64])
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.tile(np.array([[0, 1]], np.int32), (B, 1))
    for b in range(B):  # query b's best vector sits at two slots of partition b % 2
        p, lo, hi = b % 2, 2 * b, 2 * b + 1 + 30
        codes[p, lo] = codes[p, hi] = q[b] * (3.0 if metric == "ip" else 1.0)
        # The larger slot gets the smaller id, so the two rules disagree.
        ids[p, lo], ids[p, hi] = max(ids[p, lo], ids[p, hi]), min(ids[p, lo], ids[p, hi])
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    (s1, i1, _), (s2, i2, _) = _run_exact(name, codes, ids, sizes, norms, q, pids, 1, metric, qt)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-5)
    want = [ids[b % 2, 2 * b + 31] if name == "v3" else ids[b % 2, 2 * b] for b in range(B)]
    np.testing.assert_array_equal(i2[:, 0], want)
    # With k = 2 both copies surface, in the kernel's order.
    (_, j1, _), (_, j2, _) = _run_exact(name, codes, ids, sizes, norms, q, pids, 2, metric, qt)
    np.testing.assert_array_equal(j2, j1)


@pytest.mark.parametrize("mode", ["slot", "id"])
def test_exact_scan_ghosts_and_tails(mode):
    P, C, D, qt, kk = 3, 200, 8, 8, 40
    codes, ids, sizes, norms = _store(P, C, D, seed=1, sizes=[C, 0, 7])
    gp = np.array([0, 1, 2, -1], np.int32)
    gsize = np.where(gp >= 0, sizes[np.maximum(gp, 0)], 0).astype(np.int32)
    qg = np.random.default_rng(2).standard_normal((4, qt, D)).astype(np.float32)
    s, i = grouped_exact.exact_scan(_t(gp), _t(qg), _t(codes), kk, "l2", mode,
                                    group_size=_t(gsize), norms=_t(norms), ids=_t(ids))
    s, i = s.numpy(), i.numpy()
    assert s.shape == i.shape == (4, qt, kk) and i.dtype == np.int32
    assert np.isneginf(s[[1, 3]]).all() and (i[[1, 3]] == -1).all()  # empty, ghost
    assert np.isfinite(s[2, :, :7]).all() and np.isneginf(s[2, :, 7:]).all()
    assert (i[2, :, 7:] == -1).all() and (i[2, :, :7] >= 0).all()
    assert (np.diff(s[0], axis=1) <= 0).all()
    valid = ids[0][ids[0] >= 0] if mode == "id" else np.arange(sizes[0])
    assert np.isin(i[0], valid).all()


def test_exact_scan_rejects_bad_inputs():
    z = torch.zeros
    args = (z(2, dtype=torch.int32), z((2, 8, 4)), z((3, 200, 4)), 10, "l2")
    with pytest.raises(ValueError, match="mode"):
        grouped_exact.exact_scan(*args, "lane")
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_exact.exact_scan(*meta, "id", ids=z((3, 200), dtype=torch.int32, device="meta"))


# ------------------------------------------- kernels K4 (chunk table) and K7


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rowscale_chunk_table_matches_jax_group_body(metric):
    """K4's plain version with a chunk table against _v3p_group_body on each
    chunk (what _v4_kernel runs), chunk by chunk."""
    P, C, D, qt, ct, kk = 4, 384, 16, 8, 128, 10
    codes, _, sizes, norms = _store(P, C, D, seed=3, sizes=[C, 200, 0, 5])
    rng = np.random.default_rng(4)
    qg = rng.standard_normal((3, qt, D)).astype(np.float32)
    # (partition, chunk, query tile): full chunks, a partial one, one past
    # the size, an empty partition and a ghost.
    table = [(0, 0, 0), (0, 2, 1), (1, 1, 2), (1, 2, 0), (2, 0, 1), (3, 0, 2), (-1, 0, 0)]
    gp = np.array([t[0] for t in table], np.int32)
    chunk = np.array([t[1] for t in table], np.int32)
    qsrc = np.array([t[2] for t in table], np.int32)
    gsize = np.where(gp >= 0, np.clip(sizes[np.maximum(gp, 0)] - chunk * ct, 0, ct), 0).astype(
        np.int32)
    slot_mult, levels = packed_params(ct)
    out, stats = grouped_family.rowscale_scan(
        _t(gp), _t(gsize), _t(qg), _t(codes), _t(norms), kk, slot_mult, levels, metric,
        qsrc=_t(qsrc), row_off=_t(chunk * ct), ct=ct)
    assert out.shape == (len(table), qt, kk) and stats.shape == (len(table), qt, 2)
    for g, (p, c, t) in enumerate(table):
        if gsize[g] <= 0:
            assert (out[g] == -1).all()
            assert (stats[g, :, 0] == 0).all() and (stats[g, :, 1] == np.float32(1e-20)).all()
            continue
        rows = slice(c * ct, (c + 1) * ct)
        w_out, w_stats = _v3p_group_body(*_j(qg[t], codes[p, rows], norms[p, rows]),
                                         int(gsize[g]), metric, kk, slot_mult, levels)
        w_out, got = np.asarray(w_out), out[g].numpy()
        lanes = [np.where(a >= 0, np.mod(a, slot_mult), -1) for a in (got, w_out)]
        assert _row_overlap(lanes[0], lanes[1]) >= 0.99
        np.testing.assert_allclose(stats[g].numpy(), np.asarray(w_stats), rtol=1e-5, atol=1e-5)
        assert (lanes[0] < gsize[g]).all()  # chunk-local, below the chunk's size
    with pytest.raises(ValueError, match="chunk table"):
        grouped_family.rowscale_scan(_t(gp), _t(gsize), _t(qg), _t(codes), _t(norms), kk,
                                     slot_mult, levels, metric, qsrc=_t(qsrc))


def test_chunk_merge_is_rowscale_chunks_merged():
    """K7's plain version against K4's plain version on every chunk followed
    by the (score, larger slot) merge written out."""
    P, C, D, qt, ct, kk = 3, 384, 16, 8, 128, 10
    codes, _, sizes, norms = _store(P, C, D, seed=5, sizes=[C, 200, 0])
    qg = np.random.default_rng(6).standard_normal((4, qt, D)).astype(np.float32)
    gp = np.array([0, 1, 2, -1], np.int32)
    gsize = np.where(gp >= 0, sizes[np.maximum(gp, 0)], 0).astype(np.int32)
    slot_mult, levels = packed_params(ct)
    s, i = grouped_chunked.chunk_merge(_t(gp), _t(gsize), _t(qg), _t(codes), _t(norms), kk, ct,
                                       slot_mult, levels, "l2")
    assert np.isneginf(s[2:].numpy()).all() and (i[2:] == -1).all()
    for g in (0, 1):
        cands = []
        for c in range(C // ct):
            csize = np.clip(gsize[g] - c * ct, 0, ct)
            out, st = grouped_family.rowscale_scan(
                _t(gp[g:g + 1]), _t(np.array([csize], np.int32)), _t(qg), _t(codes), _t(norms),
                kk, slot_mult, levels, "l2", qsrc=_t(np.array([g], np.int32)),
                row_off=_t(np.array([c * ct], np.int32)), ct=ct)
            out, st = out[0].numpy(), st[0].numpy()
            key = np.floor(out / slot_mult)
            sc = np.where(out >= 0, st[:, 0:1] + key * (st[:, 1:2] / np.float32(levels)), -np.inf)
            cands.append((sc.astype(np.float32), np.where(out >= 0, c * ct + out % slot_mult, -1)))
        cs = np.concatenate([c[0] for c in cands], axis=1)
        ci = np.concatenate([c[1] for c in cands], axis=1).astype(np.int64)
        for r in range(qt):
            order = sorted(range(cs.shape[1]), key=lambda e: (-cs[r, e], -ci[r, e]))[:kk]
            np.testing.assert_array_equal(i[g, r].numpy(), ci[r, order])
            np.testing.assert_array_equal(s[g, r].numpy(), cs[r, order])


def test_chunk_merge_rejects_bad_inputs():
    z = torch.zeros
    args = [z(2, dtype=torch.int32), z(2, dtype=torch.int32), z((2, 8, 4)), z((3, 256, 4)),
            z((3, 256))]
    with pytest.raises(ValueError, match="C % ct"):
        grouped_chunked.chunk_merge(*args, 10, 100, 128, 1000, "l2")
    with pytest.raises(ValueError, match="kk <= ct"):
        grouped_chunked.chunk_merge(*args, 200, 128, 128, 1000, "l2")
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_chunked.chunk_merge(*(a.to("meta") for a in args), 10, 128, 128, 1000, "l2")


# ------------------------------------------------------------ v4, v5 and v6


_JAX_CHUNKED = {"v4": grouped_scan_pallas_v4, "v5": grouped_scan_pallas_v5,
                "v6": grouped_scan_pallas_v6}


@pytest.mark.parametrize("k,metric", [(10, "l2"), (10, "ip"), (200, "l2")])
@pytest.mark.parametrize("C,ct,gpb", [(256, 128, 2), (384, 128, 3)])
@pytest.mark.parametrize("name", ["v4", "v5", "v6"])
def test_chunked_wrappers_match_jax(name, C, ct, gpb, k, metric):
    """Uneven sizes with an empty partition and partitions below kk, a -1
    pid, gpb padding, and k > ct (kk = ct for v4 and v5)."""
    P, D, B, nprobe, qt = 12, 16, 32, 4, 8
    codes, ids, sizes, norms = _store(P, C, D, seed=C + k, sizes=_sizes(P, C))
    q, pids = _queries(B, D, P, nprobe, seed=k + 1)
    s1, i1, n1 = _JAX_CHUNKED[name](*_j(codes, ids, sizes, norms, q, pids), k, metric, qt=qt,
                                    ct=ct, gpb=gpb, interpret=True)
    fn = getattr(grouped_chunked, f"grouped_scan_{name}")
    s2, i2, n2 = fn(*(_t(a) for a in (codes, ids, sizes, norms, q, pids)), k, metric, qt=qt,
                    ct=ct, gpb=gpb)
    s1, i1, s2, i2 = np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy()
    assert s2.shape == (B, k) and i2.dtype == np.int32 and s2.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    _assert_rescored_match(s1, i1, s2, i2, ids, pids)


def test_v4_mat_qg_gives_the_same_result():
    P, C, D, B, nprobe, qt = 8, 256, 16, 24, 3, 8
    codes, ids, sizes, norms = _store(P, C, D, seed=11, sizes=_sizes(P, C))
    q, pids = _queries(B, D, P, nprobe, seed=12)
    args = [_t(a) for a in (codes, ids, sizes, norms, q, pids)]
    a = grouped_chunked.grouped_scan_v4(*args, 10, "l2", qt=qt, ct=128, gpb=4)
    b = grouped_chunked.grouped_scan_v4(*args, 10, "l2", qt=qt, ct=128, gpb=4, mat_qg=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["v4", "v5", "v6"])
def test_chunked_wrappers_guards(name):
    fn = getattr(grouped_chunked, f"grouped_scan_{name}")
    q, pids = torch.zeros((16, 4)), torch.zeros((16, 2), dtype=torch.int32)
    codes, ids, sizes, norms = (_t(a) for a in _store(2, 256, 4, seed=0, sizes=[256, 256]))
    with pytest.raises(ValueError, match=f"{name} needs C % ct == 0"):
        fn(codes, ids, sizes, norms, q, pids, 5, "l2", qt=8, ct=100)
    # Lifted: dedup runs, as the JAX function runs it, on a spilled store.
    arrays = spilled_store(4, 256, 8, seed=1) + queries(16, 8, 4, 3, seed=2, dense=False)
    want = getattr(jpg, f"grouped_scan_pallas_{name}")(*(jnp.asarray(a) for a in arrays), 5,
                                                       "l2", qt=8, ct=128, dedup=True,
                                                       interpret=True)
    assert_scan_parity(want, fn(*(_t(a) for a in arrays), 5, "l2", qt=8, ct=128, dedup=True))
    for shape in ((32768, 128, 4), (2, 65664, 4)):
        with pytest.raises(ValueError, match=f"{name} packs"):
            fn(torch.zeros(shape, device="meta"), ids, sizes, norms, q, pids, 5, "l2", qt=8,
               ct=128)


# ------------------------------------------------------------------ dispatch


_DISPATCH = [
    # (name, C, wrapper reached, keywords it must get)
    ("v4", 1024, "v4", dict(ct=512, gpb=8)),
    ("v4c512", 768, "v4", dict(ct=384, gpb=8)),  # 512 does not divide 768
    ("v4c256g2", 768, "v4", dict(ct=256, gpb=2)),
    ("v4c512g8", 512, "v4", dict(ct=512, gpb=8)),
    ("v5", 640, "v5", dict(ct=128, gpb=4)),
    ("v5c128g2", 256, "v5", dict(ct=128, gpb=2)),
    ("v5c96", 192, "v5", dict(ct=96, gpb=4)),
    ("v6", 200, "v6", dict(ct=200, gpb=4)),  # nothing divides: the whole slab
    ("v6c128", 256, "v6", dict(ct=128, gpb=4)),
    ("v6c300g3", 256, "v6", dict(ct=256, gpb=3)),
    ("v6", 7552, "v6", dict(ct=128, gpb=4)),
    ("v3", 200, "v3", {}),
    ("v2", 200, "v2", {}),
    ("xla", 200, "xla", dict(group_chunk=7)),
    ("approx", 200, "xla", dict(group_chunk=7)),  # any other name runs the xla scan
    ("v12", 256, "xla", dict(group_chunk=7)),
]


@pytest.mark.parametrize("kernel,C,want,kw", _DISPATCH)
def test_dispatch_reaches_wrapper(monkeypatch, kernel, C, want, kw):
    calls = []
    for name in ("v2", "v3", "v4", "v5", "v6", "xla", "v3p", "v3pn", "v7", "v8", "v11"):
        monkeypatch.setattr(coordinator, f"grouped_scan_{name}",
                            lambda *a, _n=name, **k: calls.append((_n, k)))
    codes = torch.zeros((4, C, 8), device="meta")
    coordinator.grouped_scan(codes, None, None, None, torch.zeros((16, 8)),
                             torch.zeros((16, 2), dtype=torch.int32), 10, "l2", 8, 7, kernel)
    assert len(calls) == 1 and calls[0][0] == want
    assert calls[0][1]["qt"] == 8
    for key, value in kw.items():
        assert calls[0][1][key] == value


_LIFTED = "NotImplementedError-Queue 1 item 6: spill and dedup"


@pytest.mark.parametrize("kernel,exc,match", [
    # Lifted: dedup runs through the dispatch as the JAX function runs it
    # (each case keeps the id it had as a guard).
    pytest.param("v4", None, dict(ct=256, gpb=8), id=f"v4-{_LIFTED}"),
    pytest.param("v5c128g2", None, dict(ct=128, gpb=2), id=f"v5c128g2-{_LIFTED}"),
    pytest.param("v6c128", None, dict(ct=128, gpb=4), id=f"v6c128-{_LIFTED}"),
    pytest.param("xla", None, dict(group_chunk=8), id=f"xla-{_LIFTED}"),
    ("v2", ValueError, "does not support dedup"),
    ("v3", ValueError, "does not support dedup"),
])
def test_dispatch_dedup(kernel, exc, match):
    if exc is None:  # match: the JAX function's keywords
        arrays = spilled_store(4, 256, 8, seed=3) + queries(16, 8, 4, 3, seed=4, dense=False)
        jarr = tuple(jnp.asarray(a) for a in arrays)
        if kernel == "xla":
            codes, ids, _, norms, q, pids = jarr
            want = jax_scan_xla(codes, ids, q, pids, 10, "l2", qt=8, norms=norms, dedup=True,
                                **match)
        else:
            want = getattr(jpg, f"grouped_scan_pallas_{kernel[:2]}")(
                *jarr, 10, "l2", qt=8, dedup=True, interpret=True, **match)
        got = coordinator.grouped_scan(*(_t(a) for a in arrays), 10, "l2", 8, 8, kernel,
                                       dedup=True)
        assert_scan_parity(want, got, exact_ids=kernel == "xla")
        return
    codes, ids, sizes, norms = (_t(a) for a in _store(2, 128, 8, seed=0, sizes=[128, 128]))
    with pytest.raises(exc, match=match):
        coordinator.grouped_scan(codes, ids, sizes, norms, torch.zeros((16, 8)),
                                 torch.zeros((16, 2), dtype=torch.int32), 10, "l2", 8, 8, kernel,
                                 dedup=True)


@pytest.mark.parametrize("kernel", ["xla", "v2", "v3", "v4", "v4c128g8", "v5", "v5c128g2", "v6",
                                    "v6c128"])
def test_dispatch_runs_and_agrees_with_reference(kernel):
    P, C, D, B, nprobe, qt, k = 12, 256, 16, 32, 4, 8, 10
    codes, ids, sizes, norms = _store(P, C, D, seed=21, sizes=_sizes(P, C))
    q, pids = _queries(B, D, P, nprobe, seed=22)
    args = [_t(a) for a in (codes, ids, sizes, norms, q, pids)]
    s1, i1, n1 = coordinator.grouped_scan(*args, k, "l2", qt, 8, "reference")
    s2, i2, n2 = coordinator.grouped_scan(*args, k, "l2", qt, 8, kernel)
    assert torch.equal(n1, n2)
    assert _row_overlap(i2.numpy(), i1.numpy()) >= 0.99
    same = (i1 == i2).numpy()
    np.testing.assert_allclose(s2.numpy()[same], s1.numpy()[same], rtol=1e-4, atol=1e-4)
