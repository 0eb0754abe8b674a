"""The grouped-scan generations chosen by name (v3p, v3pN, v7, v8, v9) and
their dispatch, quake_tpu_torch against the JAX package on the same inputs
(CPU).

The JAX side runs its Pallas kernels in interpret mode; the torch side runs
the plain PyTorch versions of kernels K1, K2, K4 and K5 (the wrappers take
them for CPU tensors). Inputs come from numpy seeds and go to both packages
as numpy.

Tolerances: grouping is integer arithmetic and must be equal. The scans
quantize f32 dot products with floor(), so a different order of summation
can move a key by one level and swap a tie at the top-k boundary: they
compare id overlap (>= 0.99), the exact distances of common ids (rtol = atol
= 1e-4) and, for the kernels' plain versions, per-row stats within
rtol = atol = 1e-5 (one f32 dot product summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops.grouped import build_groups as jax_build_groups
from quake_tpu.ops.pallas_grouped import (_v3p_group_body, _v7_select,
                                          grouped_scan_pallas_v3p, grouped_scan_pallas_v3pn,
                                          grouped_scan_pallas_v7, grouped_scan_pallas_v8,
                                          grouped_scan_pallas_v9)
from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu_torch import coordinator
from quake_tpu_torch.ops import grouped_family
from quake_tpu_torch.ops.grouped import build_groups, build_groups_scatter, group_layout
from quake_tpu_torch.ops.grouped_scan import packed_params
from test_torch_spill_ops import assert_scan_parity, queries, spilled_store


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


# ------------------------------------------------------------------ grouping


@pytest.mark.parametrize("B,nprobe,P,qt,seed", [
    (12, 4, 8, 8, 0),
    (40, 6, 16, 16, 1),
    (64, 3, 128, 8, 2),
    (33, 5, 16, 32, 3),
    (20, 8, 16, 64, 4),
])
def test_build_groups_matches_jax(B, nprobe, P, qt, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(-1, P, size=(B, nprobe)).astype(np.int32)
    pids[0, 1] = pids[0, 0]  # duplicate probe
    pids[1, :] = -1  # a query with no probe
    want = jax_build_groups(jnp.asarray(pids), P, qt)
    got = build_groups(_t(pids), P, qt)
    assert got[0].shape[0] == group_layout(B, nprobe, P, qt)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # The groups are build_groups_scatter's; each pair's row holds its query.
    sc = build_groups_scatter(_t(pids), P, qt)
    assert torch.equal(got[0], sc[0]) and torch.equal(got[1], sc[1])
    pg, ps = got[2].numpy(), got[3].numpy()
    ql = got[1].numpy()
    for b, j in zip(*np.nonzero(pids >= 0)):
        assert ql[pg[b, j], ps[b, j]] == b and got[0][pg[b, j]] == pids[b, j]
    assert (pg[pids < 0] == -1).all() and (ps[pids < 0] == 0).all()


# ------------------------------------------------------- kernels K4 and K5


@pytest.mark.parametrize("select,C", [("topk", 200), ("topk", 384), ("fold", 256),
                                      ("fold", 384)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rowscale_scan_matches_jax_group_body(select, C, metric):
    """K4's plain version against _v3p_group_body (_v3p_select), K5's against
    the matmul + _v7_select of _v7_kernel, group by group."""
    P, D, qt, kk = 5, 16, 8, 10
    sizes = [C, C - 70, 0, 1, 7]  # full, partial, empty, one lane, size < kk
    codes, _, sizes, norms = _store(P, C, D, seed=C, sizes=sizes)
    rng = np.random.default_rng(C + 1)
    gp = np.array([0, 1, 2, 3, 4, -1, 1], np.int32)
    gsize = np.where(gp >= 0, sizes[np.maximum(gp, 0)], 0).astype(np.int32)
    qg = rng.standard_normal((len(gp), qt, D)).astype(np.float32)
    slot_mult, levels = packed_params(C)
    out, stats = grouped_family.rowscale_scan(_t(gp), _t(gsize), _t(qg), _t(codes), _t(norms),
                                              kk, slot_mult, levels, metric, select)
    assert out.shape == (len(gp), qt, kk) and stats.shape == (len(gp), qt, 2)
    for g in range(len(gp)):
        p = max(gp[g], 0)
        if gsize[g] <= 0:  # ghost: what v3p computes for a group with no valid lane
            assert (out[g] == -1).all()
            assert (stats[g, :, 0] == 0).all() and (stats[g, :, 1] == np.float32(1e-20)).all()
            continue
        if select == "topk":
            w_out, w_stats = _v3p_group_body(jnp.asarray(qg[g]), jnp.asarray(codes[p]),
                                             jnp.asarray(norms[p]), int(gsize[g]), metric, kk,
                                             slot_mult, levels)
        else:
            prod = jnp.asarray(qg[g]) @ jnp.asarray(codes[p]).T
            scores = 2.0 * prod - jnp.asarray(norms[p])[None, :] if metric == "l2" else prod
            valid = jnp.arange(C)[None, :] < int(gsize[g])
            w_out, w_stats = _v7_select(scores, jnp.broadcast_to(valid, scores.shape), kk,
                                        slot_mult, levels, 128)
        w_out, got = np.asarray(w_out), out[g].numpy()
        lanes = [np.where(a >= 0, np.mod(a, slot_mult), -1) for a in (got, w_out)]
        assert _row_overlap(lanes[0], lanes[1]) >= 0.99
        np.testing.assert_allclose(stats[g].numpy(), np.asarray(w_stats), rtol=1e-5, atol=1e-5)
        if gsize[g] == 1:  # one valid lane: range floored at 1e-20, key 0
            assert (stats[g, :, 1] == np.float32(1e-20)).all()
            assert (got[:, 0] == 0.0).all()
        n_valid = min(int(gsize[g]), kk)
        assert (got[:, :n_valid] >= 0).all() and (got[:, n_valid:] == -1).all()
        assert (np.diff(got, axis=1) <= 0).all()  # descending


def test_rowscale_scan_rejects_bad_inputs():
    z = torch.zeros
    args = (z(2, dtype=torch.int32), z(2, dtype=torch.int32), z((2, 8, 4)), z((3, 200, 4)),
            z((3, 200)), 10, 256, 65534, "l2")
    with pytest.raises(ValueError, match="C % 128"):
        grouped_family.rowscale_scan(*args, select="fold")
    with pytest.raises(ValueError, match="select"):
        grouped_family.rowscale_scan(*args, select="exact")
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_family.rowscale_scan(*meta)


# ------------------------------------------------------------------ wrappers


_JAX = {"v3p": grouped_scan_pallas_v3p, "v3pn": grouped_scan_pallas_v3pn,
        "v7": grouped_scan_pallas_v7, "v8": grouped_scan_pallas_v8,
        "v9": grouped_scan_pallas_v9}
_WRAPPER_CASES = [
    ("v3p", {}, 200), ("v3p", {}, 384),
    ("v3pn", dict(gpb=2), 200), ("v3pn", dict(gpb=4), 256),
    ("v7", dict(gpb=2), 256), ("v7", dict(gpb=4), 384),
    ("v8", dict(gpb=2), 256), ("v8", dict(gpb=4), 384),
    ("v9", dict(gpb=4), 256),
]


@pytest.mark.parametrize("k,metric", [(10, "l2"), (10, "ip"), (300, "l2")])
@pytest.mark.parametrize("name,kw,C", _WRAPPER_CASES)
def test_wrappers_match_jax(name, kw, C, k, metric):
    """Ghost groups (an empty partition, gpb padding), partitions smaller
    than kk, a -1 pid, and k > C (kk = C: v8/v9 take the top-k merge)."""
    P, D, B, nprobe, qt = 8, 16, 24, 4, 8
    sizes = [C, C - 56, 0, 5, C, C // 2, C, 90]
    codes, ids, sizes, norms = _store(P, C, D, seed=C + k, sizes=sizes)
    rng = np.random.default_rng(k)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    pids[3, 2] = -1
    s1, i1, n1 = _JAX[name](*(jnp.asarray(a) for a in (codes, ids, sizes, norms, q, pids)),
                            k, metric, qt=qt, interpret=True, **kw)
    fn = getattr(grouped_family, f"grouped_scan_{name}")
    s2, i2, n2 = fn(*(_t(a) for a in (codes, ids, sizes, norms, q, pids)), k, metric, qt=qt,
                    **kw)
    s1, i1, s2, i2 = np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy()
    assert s2.shape == (B, k) and i2.dtype == np.int32 and s2.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    assert _row_overlap(i2, i1) >= 0.99
    for b in range(B):
        common = set(i1[b][i1[b] >= 0].tolist()) & set(i2[b][i2[b] >= 0].tolist())
        for v in common:
            np.testing.assert_allclose(s2[b][i2[b] == v][0], s1[b][i1[b] == v][0],
                                       rtol=1e-4, atol=1e-4)
        allowed = ids[pids[b][pids[b] >= 0]]
        assert np.isin(i2[b][i2[b] >= 0], allowed[allowed >= 0]).all()
        assert np.isneginf(s2[b][i2[b] < 0]).all()


@pytest.mark.parametrize("k,merges", [(10, 1), (600, 0)])
def test_v8_merge_choice(monkeypatch, k, merges):
    """_global_epilogue's rule: kernel K2 merges the pool unless kk < k (or
    the packed pool key needs more than 24 bits). At nprobe 1 and C = 512 the
    pool key fits, so only kk = C < k = 600 sends it to the top-k merge."""
    from quake_tpu_torch.ops import grouped_scan

    calls = []
    real = grouped_scan.merge_positions
    monkeypatch.setattr(grouped_scan, "merge_positions",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    P, C, D, B = 4, 512, 8, 16
    codes, ids, sizes, norms = _store(P, C, D, seed=9, sizes=[C, C, 300, C])
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(0, P, size=(B, 1)).astype(np.int32)
    args = (codes, ids, sizes, norms, q, pids)
    _, i1, _ = grouped_scan_pallas_v8(*(jnp.asarray(a) for a in args), k, "l2", qt=8, gpb=2,
                                      interpret=True)
    _, i2, _ = grouped_family.grouped_scan_v8(*(_t(a) for a in args), k, "l2", qt=8, gpb=2)
    assert len(calls) == merges
    assert _row_overlap(i2.numpy(), np.asarray(i1)) >= 0.99


@pytest.mark.parametrize("name", ["v3pn", "v7", "v8", "v9"])
def test_wrappers_dedup_not_ported(name):
    """Lifted (the name kept as it was): dedup on a spilled store, each id
    in two partitions, as the JAX function computes it."""
    arrays = spilled_store(4, 128, 4, seed=0) + queries(16, 4, 4, 3, seed=1, dense=False)
    jfn = {"v3pn": grouped_scan_pallas_v3pn, "v7": grouped_scan_pallas_v7,
           "v8": grouped_scan_pallas_v8, "v9": grouped_scan_pallas_v9}[name]
    want = jfn(*(jnp.asarray(a) for a in arrays), 5, "l2", qt=8, dedup=True, interpret=True)
    got = getattr(grouped_family, f"grouped_scan_{name}")(*(_t(a) for a in arrays), 5, "l2",
                                                          qt=8, dedup=True)
    assert_scan_parity(want, got)


# ------------------------------------------------------------------ dispatch


_DISPATCH = [
    # (name, C, wrapper reached, gpb it gets)
    ("v3p", 256, "v3p", None),
    ("v3p2", 256, "v3pn", 2),
    ("v3p4", 200, "v3pn", 4),
    ("v7", 256, "v7", 4),
    ("v7g2", 256, "v7", 2),
    ("v8", 256, "v8", 4),
    ("v8g2f128", 256, "v8", 2),
    ("v9g4", 256, "v8", 4),  # v9 is v8's function on kernel K1
    ("v10", 256, "v10", 4),
    ("v10g2", 256, "v10", 2),
    ("v11g2", 256, "v11", 2),
    ("v11g4f256", 384, "v3pn", 4),  # C % 256 != 0: the v3pN fallback
    ("v10g4f256", 384, "v3pn", 4),
    ("v7g2", 200, "v3pn", 2),
    ("v8g8", 200, "v3pn", 8),
    ("v9", 200, "v3pn", 4),
]


@pytest.mark.parametrize("kernel,C,want,gpb", _DISPATCH)
def test_dispatch_reaches_wrapper(monkeypatch, kernel, C, want, gpb):
    calls = []
    for name in ("v3p", "v3pn", "v7", "v8", "v10", "v11"):
        monkeypatch.setattr(coordinator, f"grouped_scan_{name}",
                            lambda *a, _n=name, **kw: calls.append((_n, kw.get("gpb"))))
    codes = torch.zeros((4, C, 8))
    coordinator.grouped_scan(codes, None, None, None, torch.zeros((16, 8)),
                             torch.zeros((16, 2), dtype=torch.int32), 10, "l2", 8, 8, kernel,
                             dense=True)
    assert calls == [(want, gpb)]


@pytest.mark.parametrize("kernel,match", [
    ("v10g4f256", "fold by 128"), ("v7f256", "fold by 128"), ("v8g2f256", "fold by 128"), ("v9f256", "fold by 128"),
    ("v11g4f256", "fold by 128"),
])
def test_dispatch_unported_names_raise(kernel, match):
    """Lifted (each case keeps the id it had as a refusal): a fold of 256 on
    C = 512 runs through the dispatch as the JAX function computes it, K1
    (or K5 for v7) folding by 256 in its plain version."""
    name, gpb = coordinator._FOLDED.match(kernel).group(1, 2)
    codes, ids, sizes, norms = _store(6, 512, 8, seed=11, sizes=[512, 300, 0, 129, 512, 40])
    q, pids = queries(24, 8, 6, 3, seed=12)
    arrays = (codes, ids, sizes, norms, q, pids)
    want = getattr(jpg, f"grouped_scan_pallas_{name}")(
        *(jnp.asarray(a) for a in arrays), 10, "l2", qt=8, gpb=int(gpb or 4), fold=256,
        interpret=True)
    got = coordinator.grouped_scan(*(_t(a) for a in arrays), 10, "l2", 8, 8, kernel, dense=True)
    assert_scan_parity(want, got)


_LIFTED = "True-True-NotImplementedError-Queue 1 item 6: spill and dedup"


@pytest.mark.parametrize("kernel,dense,dedup,exc,match", [
    ("v2", True, True, ValueError, "does not support dedup"),
    ("v3", True, True, ValueError, "does not support dedup"),
    ("v3p", True, True, ValueError, "does not support dedup"),
    # Lifted: dedup runs through the dispatch as the JAX function runs it;
    # masked v11 rides v10 (each case keeps the id it had as a guard).
    pytest.param("v3p4", True, True, None, ("v3pn", dict(gpb=4)), id=f"v3p4-{_LIFTED}"),
    pytest.param("v10", True, True, None, ("v10", dict(gpb=4)), id=f"v10-{_LIFTED}"),
    pytest.param("v11", False, True, None, ("v10", dict(gpb=4)),
                 id="v11-False-True-NotImplementedError-Queue 1 item 6: spill and dedup"),
])
def test_dispatch_guards(kernel, dense, dedup, exc, match):
    if exc is None:  # match: the JAX function the name reaches, its keywords
        arrays = spilled_store(4, 128, 8, seed=2) + queries(16, 8, 4, 3, seed=3, dense=dense)
        name, kw = match
        want = getattr(jpg, f"grouped_scan_pallas_{name}")(
            *(jnp.asarray(a) for a in arrays), 10, "l2", qt=8, dedup=True, interpret=True, **kw)
        got = coordinator.grouped_scan(*(_t(a) for a in arrays), 10, "l2", 8, 8, kernel,
                                       dedup=True, dense=dense)
        assert_scan_parity(want, got)
        return
    codes, ids, sizes, norms = _store(2, 128, 8, seed=0, sizes=[128, 128])
    kw = {} if dense is None else dict(dense=dense)
    with pytest.raises(exc, match=match):
        coordinator.grouped_scan(_t(codes), _t(ids), _t(sizes), _t(norms),
                                 torch.zeros((16, 8)), torch.zeros((16, 2), dtype=torch.int32),
                                 10, "l2", 8, 8, kernel, dedup=dedup, **kw)
