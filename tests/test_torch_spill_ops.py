"""The dedup tails of a SOAR-spilled store (every vector resident in two
partitions), quake_tpu_torch against the JAX package on the same inputs
(CPU): `rescore_topk(dedup=True)` (exact and dequantized), the v10/v11/v10b
pool tail with dedup (which takes the general path: kernel K2 does not
run), `merge_groups(dedup=True)`, and every scan wrapper that takes
`dedup` against its JAX function (Pallas kernels in interpret mode).

The store is planted: each id sits in two different partitions with the
same vector, so an undeduplicated merge would return it twice.

Tolerances: the tails on given pools are integer selection plus one f32
rescore: ids equal, scores within rtol = atol = 1e-5 (exact) or 1e-6
(dequantized, the same arithmetic). The scans quantize with floor(), so
another order of summation can move a key by one level and swap a near-tie
at the top-k boundary: id overlap >= 0.99 and the exact distances of common
ids within rtol = atol = 1e-4; the "xla" scan selects on exact scores: ids
equal. Every result row holds each id at most once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops.grouped import grouped_scan_xla as jax_scan_xla
from quake_tpu.ops.pallas_grouped import _rescore_topk as jax_rescore_topk
from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu_torch.ops import grouped_chunked, grouped_family
from quake_tpu_torch.ops import grouped_scan as tgs
from quake_tpu_torch.ops.grouped import grouped_scan_xla
from quake_tpu_torch.ops.grouped_scan import rescore_topk


def _t(a):
    return torch.from_numpy(np.array(a))


def spilled_store(P, C, D, seed, n=None):
    """A compact-prefix store holding n vectors twice each, in two different
    partitions (ids a random subset of a wider range, so slot order, id
    order and partition order differ), padding poisoned with 10.0.
    Returns (codes, ids, sizes, norms)."""
    rng = np.random.default_rng(seed)
    n = n or P * C // 4
    x = rng.standard_normal((n, D)).astype(np.float32)
    vid = rng.permutation(8 * n)[:n].astype(np.int32)
    p1 = rng.integers(0, P, n)
    p2 = (p1 + rng.integers(1, P, n)) % P
    rows = np.concatenate([p1, p2])
    order = rng.permutation(2 * n)
    codes = np.full((P, C, D), 10.0, np.float32)
    ids = np.full((P, C), -1, np.int32)
    sizes = np.zeros(P, np.int32)
    for j in order:
        r = rows[j]
        assert sizes[r] < C
        codes[r, sizes[r]] = x[j % n]
        ids[r, sizes[r]] = vid[j % n]
        sizes[r] += 1
    norms = (codes ** 2).sum(axis=2).astype(np.float32)
    return codes, ids, sizes, norms


def queries(B, D, P, nprobe, seed, dense=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    if not dense:
        pids[3, 2] = -1
        pids[5, :] = -1  # a query with no probe
    return q, pids


def assert_no_dups(ids):
    for row in np.asarray(ids):
        valid = row[row >= 0]
        assert len(valid) == len(set(valid.tolist())), row


def overlap(a, b):
    """Mean over rows of |set(a_row) & set(b_row)| / |set(b_row)| (-1 ignored)."""
    tot = 0.0
    for ra, rb in zip(np.asarray(a), np.asarray(b)):
        sa, sb = set(ra[ra >= 0].tolist()), set(rb[rb >= 0].tolist())
        tot += len(sa & sb) / max(len(sb), 1) if sb else float(not sa)
    return tot / len(a)


def assert_scan_parity(want, got, exact_ids=False):
    """(scores, ids, scanned) of the JAX scan and the port's: no duplicate
    ids, scanned equal, ids equal (exact_ids) or overlapping >= 0.99 with
    the common ids' scores within 1e-4."""
    sw, iw, nw = (np.asarray(a) for a in want)
    sg, ig, ng = (a.numpy() for a in got)
    assert_no_dups(iw)
    assert_no_dups(ig)
    np.testing.assert_array_equal(ng, nw)
    if exact_ids:
        np.testing.assert_array_equal(ig, iw)
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-5)
        return
    assert overlap(ig, iw) >= 0.99
    for b in range(len(ig)):
        common = set(ig[b][ig[b] >= 0].tolist()) & set(iw[b][iw[b] >= 0].tolist())
        for i in common:
            np.testing.assert_allclose(sg[b][ig[b] == i], sw[b][iw[b] == i], rtol=1e-4,
                                       atol=1e-4)


P, C, D = 12, 256, 16


@pytest.fixture(scope="module")
def store():
    return spilled_store(P, C, D, seed=3)


# ------------------------------------------------------- rescore_topk(dedup)


@pytest.mark.parametrize("k,exact,metric", [(5, True, "l2"), (40, True, "ip"),
                                            (10, False, "l2"), (40, False, "ip")])
def test_rescore_topk_dedup_matches_jax(store, k, exact, metric):
    """A pool of refs over the planted store in which many ids arrive
    through both copies (and some refs are -1): the top 2k by key, each
    id's first occurrence kept, the first k survivors rescored exactly or
    their keys dequantized."""
    codes, ids, sizes, norms = store
    rng = np.random.default_rng(k)
    B, pool = 9, 96
    pid = rng.integers(0, P, (B, pool))
    slot = rng.integers(0, sizes[pid].clip(min=1))
    m_refs = ((pid << 16) | slot).astype(np.int32)
    m_refs[:, ::11] = -1
    m_refs[0] = -1  # a row with no candidate
    # Both copies of some ids: a second ref to the twin of a chosen slot.
    for b in range(1, B):
        for j in range(0, pool - 1, 3):
            if m_refs[b, j] < 0:
                continue
            vid = ids[m_refs[b, j] >> 16, m_refs[b, j] & 0xFFFF]
            r, s = np.argwhere(ids == vid)[-1]
            m_refs[b, j + 1] = (r << 16) | s
    m_scores = rng.permutation(B * pool).reshape(B, pool).astype(np.float32)
    m_scores = np.where(m_refs >= 0, m_scores, -np.inf).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(0, P, (B, 4)).astype(np.int32)
    gmin, ginv = np.float32(-40.0), np.float32(3.5)
    arrays = (m_scores, m_refs, codes, ids, norms, q)
    want = jax_rescore_topk(*(jnp.asarray(a) for a in arrays), k, 4, metric, jnp.asarray(pids),
                            dedup=True, exact=exact, gmin=jnp.asarray(gmin),
                            ginv=jnp.asarray(ginv))
    got = rescore_topk(*(_t(a) for a in arrays), k, 4, metric, _t(pids), dedup=True,
                       exact=exact, gmin=torch.tensor(gmin), ginv=torch.tensor(ginv))
    assert_no_dups(got[1].numpy())
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    tol = 1e-5 if exact else 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=tol, atol=tol)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # Without dedup the same pool returns some id twice.
    _, dup_ids, _ = rescore_topk(*(_t(a) for a in arrays), k, 4, metric, _t(pids))
    assert any(len(set(r[r >= 0].tolist())) < (r >= 0).sum() for r in dup_ids.numpy())


# ------------------------------------- v10, v11, v10b: the pool tail's dedup


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", ["v11", "v10", "v10b"])
def test_placed_scan_dedup_matches_jax(store, name, exact, monkeypatch):
    """The v10/v11/v10b scans with dedup against the JAX ones: the pool tail
    takes its general path (a top-k of the pool's keys with the dedup), so
    kernel K2 (merge_positions) does not run."""
    codes, ids, sizes, norms = store
    q, pids = queries(32, D, P, 4, seed=5, dense=name == "v11")
    k, qt = 10, 8
    arrays = (codes, ids, sizes, norms, q, pids)
    kw = dict(qt=qt, gpb=2, dedup=True, exact=exact)
    if name == "v10b":
        kw["pair_budget"] = int((pids >= 0).sum())
    jfn = getattr(jpg, f"grouped_scan_pallas_{name}")
    want = jfn(*(jnp.asarray(a) for a in arrays), k, "l2", interpret=True, **kw)
    calls = []
    real = tgs.merge_positions
    monkeypatch.setattr(tgs, "merge_positions", lambda *a, **kw2: calls.append(1) or real(*a))
    got = getattr(tgs, f"grouped_scan_{name}")(*(_t(a) for a in arrays), k, "l2", **kw)
    assert not calls
    assert_scan_parity(want, got)
    # Without dedup the same scan runs K2 and returns duplicates.
    kw["dedup"] = False
    _, dup_ids, _ = getattr(tgs, f"grouped_scan_{name}")(*(_t(a) for a in arrays), k, "l2", **kw)
    assert calls
    assert any(len(set(r[r >= 0].tolist())) < (r >= 0).sum() for r in dup_ids.numpy())


# ------------------------------------------------ merge_groups and "xla"


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [10, 300])
def test_grouped_scan_xla_dedup_matches_jax(store, k, metric):
    """merge_groups(dedup=True) through the "xla" scan (exact scores): ids
    equal to the JAX scan's, none twice; k past the pool pads with -1."""
    codes, ids, sizes, norms = store
    q, pids = queries(32, D, P, 4, seed=7, dense=False)
    want = jax_scan_xla(*(jnp.asarray(a) for a in (codes, ids, q, pids)), k, metric, qt=8,
                        group_chunk=5, norms=jnp.asarray(norms), dedup=True)
    got = grouped_scan_xla(*(_t(a) for a in (codes, ids, q, pids)), k, metric, qt=8,
                           group_chunk=5, norms=_t(norms), dedup=True)
    assert_scan_parity(want, got, exact_ids=True)


# ---------------------------------------------------- the by-name wrappers


@pytest.mark.parametrize("name,kw", [
    ("v3pn", dict(gpb=2)),
    ("v7", dict(gpb=4)),
    ("v8", dict(gpb=4)),
    ("v9", dict(gpb=2)),
    ("v4", dict(ct=128, gpb=4)),
    ("v5", dict(ct=128, gpb=2)),
    ("v6", dict(ct=128, gpb=4)),
])
def test_wrappers_dedup_match_jax(store, name, kw):
    """Each wrapper's dedup=True against its JAX function on the planted
    store: the v3p epilogue's dedup (v3pN, v7, v6), the global epilogue's
    (v8, v9) and rescore_topk's (v4, v5)."""
    codes, ids, sizes, norms = store
    q, pids = queries(32, D, P, 4, seed=9, dense=False)
    arrays = (codes, ids, sizes, norms, q, pids)
    jfn = getattr(jpg, f"grouped_scan_pallas_{name}")
    want = jfn(*(jnp.asarray(a) for a in arrays), 10, "l2", qt=8, dedup=True, interpret=True,
               **kw)
    mod = grouped_chunked if name in ("v4", "v5", "v6") else grouped_family
    got = getattr(mod, f"grouped_scan_{name}")(*(_t(a) for a in arrays), 10, "l2", qt=8,
                                               dedup=True, **kw)
    assert_scan_parity(want, got)
