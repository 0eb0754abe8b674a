"""The split-precision product of the tensor-core kernels (K1, K3-K7 and
multi_topk; quake_tpu_torch/ops/split_product.py) on the CPU: the plain model
of what the kernels compute on the tensor cores, held to the f32 plain
versions and to the JAX package.

Inputs come from numpy seeds. Tolerances:

- hi + lo reproduces x to 2^-21 (the residual's own rounding is 2^-22), and
  both halves are TF32 values: 13 zero low mantissa bits.
- split_matmul errs against a float64 product no more than 4 times what
  torch.matmul in f32 errs (it drops the q_lo x_lo term; its sums are
  exact).
- Keys are a floor() of the product, so two f32-accurate products may differ
  by one level on the few lanes whose score lies at a level's edge: under
  0.5% of the valid lanes (1% for the per-row keys at C = 256, whose levels
  are half as wide), never more than one level, winners overlap >= 0.99,
  per-row stats within rtol = atol = 1e-4.
- Against quake_tpu's Pallas scans in interpret mode (v11, v3pN, v7, v3,
  v2): id overlap >= 0.99, as the f32 plain versions are held to them, and
  the distances of common ids within rtol = atol = 1e-4 (rescored exactly,
  or, v3 and v2, the exact scores themselves).
- A single TF32 product moves keys by more than one level: why the kernels
  split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quake_tpu_torch.ops.grouped_exact as grouped_exact
import quake_tpu_torch.ops.grouped_family as grouped_family
import quake_tpu_torch.ops.grouped_scan as grouped_scan
from quake_tpu.ops.pallas_grouped import (grouped_scan_pallas, grouped_scan_pallas_v3,
                                          grouped_scan_pallas_v3pn, grouped_scan_pallas_v7,
                                          grouped_scan_pallas_v11)
from quake_tpu_torch.ops.grouped_exact import exact_scan_plain
from quake_tpu_torch.ops.grouped_family import (grouped_scan_v3pn, grouped_scan_v7,
                                                rowscale_scan, rowscale_scan_plain)
from quake_tpu_torch.ops.grouped_scan import (fold_rounds, grouped_scan_plain, grouped_scan_v11,
                                              packed_params)
from quake_tpu_torch.ops.split_product import (bmm_as_split_product, split_matmul, tf32_round,
                                               tf32_split)

STATS_TOL = 1e-4
OVERLAP_TOL = 0.99
EDGE_SHARE = 0.005  # lanes whose key may sit on the other side of a level's edge


def _t(a):
    return torch.from_numpy(np.array(a))


def tf32_matmul(q, x):
    """The single TF32 product q_hi x_hi: what the kernels would compute
    without the split."""
    return torch.matmul(tf32_round(q), tf32_round(x).transpose(-1, -2))


def _low_bits(x):
    return x.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 3e4), (3, 1e-30)])
def test_tf32_split_reconstructs_x(seed, scale):
    rng = np.random.default_rng(seed)
    x = _t((rng.standard_normal((257, 100)) * scale).astype(np.float32))
    hi, lo = tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert int(_low_bits(hi).abs().max()) == 0 and int(_low_bits(lo).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert float((err / x.double().abs().clamp(min=1e-300)).max()) <= 2.0 ** -21
    assert float(((hi - x).abs() / x.abs().clamp(min=1e-38)).max()) <= 2.0 ** -11


def test_tf32_round_is_nearest_with_ties_away():
    one = np.float32(1.0).view(np.int32)
    bits = np.array([one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x2FFF, one + 0x3000],
                    np.int32)
    x = _t(np.concatenate([bits.view(np.float32), -bits.view(np.float32)]))
    want = np.array([one, one + 0x2000, one + 0x2000, one + 0x2000, one + 0x4000], np.int32)
    want = np.concatenate([want.view(np.float32), -want.view(np.float32)])
    np.testing.assert_array_equal(tf32_round(x).numpy(), want)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf")])
    assert torch.equal(tf32_round(special), special)
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("D", [24, 100, 128])
def test_split_matmul_keeps_f32_accuracy(D):
    rng = np.random.default_rng(D)
    q = _t(rng.standard_normal((64, D)).astype(np.float32) * 7.0)
    x = _t(rng.standard_normal((512, D)).astype(np.float32) * 3.0)
    exact = q.double() @ x.double().T
    err_split = float((split_matmul(q, x).double() - exact).abs().max())
    err_f32 = float((torch.matmul(q, x.T).double() - exact).abs().max())
    err_tf32 = float((tf32_matmul(q, x).double() - exact).abs().max())
    assert err_split <= 4.0 * err_f32
    assert err_tf32 >= 50.0 * err_f32  # what the split buys
    batched = split_matmul(q[None].expand(3, -1, -1), x[None].expand(3, -1, -1))
    assert batched.shape == (3, 64, 512) and torch.equal(batched[1], split_matmul(q, x))


def _k1_inputs(qt, C, D=128, seed=0):
    """Global-scale inputs of kernel K1: groups over partitions of uneven
    sizes, with ghosts (gp = -1 and an empty partition)."""
    rng = np.random.default_rng(seed + qt + C)
    P, Gn = 6, 14
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    sizes = np.array([C, C - 70, 0, 1, 129, 150], np.int32)
    gp = rng.integers(-1, P, Gn).astype(np.int32)
    gsize = np.where(gp >= 0, sizes[np.clip(gp, 0, None)], 0).astype(np.int32)
    slot_mult, levels = packed_params(C)
    scale = levels / (10.0 * D ** 0.5)
    q = rng.standard_normal((Gn, qt, D)).astype(np.float32)
    normsT = (((codes ** 2).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).astype(np.float32)
    return dict(gp=_t(gp), gsize=_t(gsize), qg=_t(q * np.float32(scale)), codes=_t(codes),
                normsT=_t(normsT), slot_mult=slot_mult, levels=levels, q=_t(q),
                norms=_t((codes ** 2).sum(-1).astype(np.float32)))


def _k1_keys(inp, product):
    """Kernel K1's key of every (group, row, lane); the valid-lane mask."""
    alive = torch.nonzero(inp["gsize"] > 0).flatten()
    p = inp["gp"][alive].long()
    prod = product(inp["qg"][alive], inp["codes"][p])
    keys = torch.clamp(torch.floor(prod - inp["normsT"][p][:, None, :]), 0.0, float(inp["levels"]))
    C = inp["codes"].shape[1]
    valid = torch.arange(C)[None, None, :] < inp["gsize"][alive][:, None, None]
    return keys, valid.expand_as(keys)


def _f32_matmul(q, x):
    return torch.matmul(q, x.transpose(-1, -2))


def _lanes(packed, slot_mult):
    return torch.where(packed >= 0, torch.remainder(packed, slot_mult),
                       torch.full_like(packed, -1))


def _overlap(a, b):
    """Mean over rows of the share of b's winners that a also has."""
    tot = 0.0
    for ra, rb in zip(a.tolist(), b.tolist()):
        sa, sb = {v for v in ra if v >= 0}, {v for v in rb if v >= 0}
        tot += len(sa & sb) / len(sb) if sb else float(not sa)
    return tot / a.shape[0]


@pytest.mark.parametrize("C", [256, 512])
@pytest.mark.parametrize("qt", [8, 64])
def test_k1_keys_from_the_split_product(qt, C):
    inp = _k1_inputs(qt, C)
    k_f32, valid = _k1_keys(inp, _f32_matmul)
    k_split, _ = _k1_keys(inp, split_matmul)
    diff = (k_f32 - k_split).abs()[valid]
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < EDGE_SHARE
    assert float(k_f32[valid].max()) > 0.5 * inp["levels"]  # the keys use the scale
    kk = 10
    args = (inp["gp"], inp["gsize"], inp["qg"], inp["codes"], inp["normsT"], kk,
            inp["slot_mult"], inp["levels"])
    want = grouped_scan_plain(*args)
    with bmm_as_split_product():
        got = grouped_scan_plain(*args)
    ghosts = inp["gsize"] <= 0
    assert bool(ghosts.any()) and bool((got[ghosts] == -1).all())
    assert torch.equal(got >= 0, want >= 0)
    sm = inp["slot_mult"]
    assert _overlap(_lanes(got, sm).reshape(-1, kk), _lanes(want, sm).reshape(-1, kk)) >= OVERLAP_TOL


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("C", [256, 512])
@pytest.mark.parametrize("qt", [8, 64])
def test_rowscale_keys_from_the_split_product(qt, C, metric):
    inp = _k1_inputs(qt, C, seed=1)
    sm, levels = inp["slot_mult"], inp["levels"]
    # kk = C: every lane's packed value comes out, so the keys of all lanes compare.
    args = (inp["gp"], inp["gsize"], inp["q"], inp["codes"], inp["norms"], C, sm, levels, metric,
            "topk")
    want, want_stats = rowscale_scan_plain(*args)
    with bmm_as_split_product():
        got, got_stats = rowscale_scan_plain(*args)
    torch.testing.assert_close(got_stats, want_stats, rtol=STATS_TOL, atol=STATS_TOL)
    ghosts = inp["gsize"] <= 0
    assert bool((got[ghosts] == -1).all()) and bool((got_stats[ghosts][..., 1] == 1e-20).all())

    def lane_keys(packed):
        """[Gn, qt, C] key of every lane (-1 where the row has none for it)."""
        keys = torch.full(packed.shape[:2] + (C + 1,), -1.0)
        lanes = _lanes(packed, sm).long()
        keys.scatter_(2, torch.where(lanes >= 0, lanes, torch.full_like(lanes, C)),
                      torch.floor(packed / sm))
        return keys[..., :C]

    k_f32, k_split = lane_keys(want), lane_keys(got)
    valid = torch.arange(C)[None, None, :] < inp["gsize"][:, None, None]
    valid = valid.expand_as(k_f32)
    assert bool((k_f32[valid] >= 0).all()) and bool((k_split[valid] >= 0).all())
    diff = (k_f32 - k_split).abs()[valid]
    assert float(diff.max()) <= 1.0
    # A row's own range is cut into `levels` levels: 32,766 at C = 512, twice
    # as many (each half as wide, so twice the lanes within an f32 rounding of
    # an edge) at C = 256.
    assert float((diff > 0).float().mean()) < EDGE_SHARE * max(1.0, levels / 32766)
    kk = 10
    a, b = _lanes(got[..., :kk], sm).reshape(-1, kk), _lanes(want[..., :kk], sm).reshape(-1, kk)
    assert _overlap(a, b) >= OVERLAP_TOL
    fargs = (*args[:5], kk, *args[6:9], "fold")
    folded = [rowscale_scan_plain(*fargs)[0]]
    with bmm_as_split_product():
        folded.append(rowscale_scan_plain(*fargs)[0])
    assert _overlap(_lanes(folded[1], sm).reshape(-1, kk),
                    _lanes(folded[0], sm).reshape(-1, kk)) >= OVERLAP_TOL


def test_a_single_tf32_product_breaks_the_one_level_bound():
    """Why the kernels split: one TF32 product (10 mantissa bits) over D = 128
    terms moves keys by many levels, on a large share of the lanes."""
    inp = _k1_inputs(64, 512)
    k_f32, valid = _k1_keys(inp, _f32_matmul)
    k_tf32, _ = _k1_keys(inp, tf32_matmul)
    k_split, _ = _k1_keys(inp, split_matmul)
    diff = (k_f32 - k_tf32).abs()[valid]
    assert float(diff.max()) > 1.0
    assert float((diff > 0).float().mean()) > 10 * EDGE_SHARE
    assert float((k_f32 - k_split).abs()[valid].max()) <= 1.0


# --------------------------------------------------- against the JAX package


def _store(P, C, D, seed, sizes):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    sizes = np.asarray(sizes, np.int32)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0  # poison: must never be selected
    return codes, ids, sizes, (codes ** 2).sum(axis=2).astype(np.float32)


def _search_inputs(seed, D=32):
    P, C, B, nprobe = 8, 256, 24, 4
    codes, ids, sizes, norms = _store(P, C, D, seed, [256, 200, 0, 17, 256, 130, 256, 90])
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    return codes, ids, sizes, norms, q, pids


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("placement", ["sorted", "argsort"])
def test_v11_on_the_split_product_matches_pallas(monkeypatch, metric, placement):
    """grouped_scan_v11 with kernel K1 replaced by its plain version on the
    split product, against grouped_scan_pallas_v11 in interpret mode."""
    def k1_split(*args, **kw):
        with bmm_as_split_product():
            return grouped_scan_plain(*args, **kw)

    monkeypatch.setattr(grouped_scan, "grouped_scan_kernel", k1_split)
    arrays = _search_inputs(41)
    k, qt, gpb = 10, 8, 2
    _, want, n1 = grouped_scan_pallas_v11(*map(jnp.asarray, arrays), k, metric, qt=qt, gpb=gpb,
                                          interpret=True, placement=placement)
    _, got, n2 = grouped_scan_v11(*map(_t, arrays), k, metric, qt=qt, gpb=gpb,
                                  placement=placement)
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    assert _overlap(got, _t(want)) >= OVERLAP_TOL


def _on_split_product(plain):
    """`plain` (a kernel's plain version) run on the split product's model."""
    def run(*args, **kw):
        with bmm_as_split_product():
            return plain(*args, **kw)

    return run


def _agrees_with_pallas(want_scores, want_ids, got_scores, got_ids):
    """Id overlap >= OVERLAP_TOL, and common ids carry the same distances
    within rtol = atol = 1e-4."""
    assert _overlap(got_ids, _t(np.asarray(want_ids))) >= OVERLAP_TOL
    s1, want, s2, got = (np.asarray(want_scores), np.asarray(want_ids), got_scores.numpy(),
                         got_ids.numpy())
    for b in range(len(got)):
        for v in set(want[b][want[b] >= 0].tolist()) & set(got[b][got[b] >= 0].tolist()):
            np.testing.assert_allclose(s2[b][got[b] == v][0], s1[b][want[b] == v][0],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("gpb", [2, 4])
def test_v3pn_on_the_split_product_matches_pallas(monkeypatch, metric, gpb):
    """grouped_scan_v3pn with kernel K4 replaced by its plain version on the
    split product, against grouped_scan_pallas_v3pn in interpret mode. The
    winners are rescored exactly: common ids carry the same distances."""
    monkeypatch.setattr(grouped_family, "rowscale_scan", _on_split_product(rowscale_scan_plain))
    arrays = _search_inputs(43)
    k, qt = 10, 8
    s1, want, _ = grouped_scan_pallas_v3pn(*map(jnp.asarray, arrays), k, metric, qt=qt, gpb=gpb,
                                           interpret=True)
    s2, got, _ = grouped_scan_v3pn(*map(_t, arrays), k, metric, qt=qt, gpb=gpb)
    _agrees_with_pallas(s1, want, s2, got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_v7_on_the_split_product_matches_pallas(monkeypatch, metric):
    """grouped_scan_v7 with kernel K5 replaced by its plain version on the
    split product, against grouped_scan_pallas_v7 in interpret mode."""
    monkeypatch.setattr(grouped_family, "rowscale_scan", _on_split_product(rowscale_scan_plain))
    arrays = _search_inputs(47)
    k, qt, gpb = 10, 8, 4
    s1, want, _ = grouped_scan_pallas_v7(*map(jnp.asarray, arrays), k, metric, qt=qt, gpb=gpb,
                                         interpret=True)
    s2, got, _ = grouped_scan_v7(*map(_t, arrays), k, metric, qt=qt, gpb=gpb)
    _agrees_with_pallas(s1, want, s2, got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_v3_on_the_split_product_matches_pallas(monkeypatch, metric):
    """grouped_scan_v3 with kernel K6 (mode slot) replaced by its plain
    version on the split product, against grouped_scan_pallas_v3 in interpret
    mode: the scores are the exact ones, so common ids carry the same
    distances."""
    monkeypatch.setattr(grouped_exact, "exact_scan", _on_split_product(exact_scan_plain))
    arrays = _search_inputs(53)
    k, qt = 10, 8
    s1, want, _ = grouped_scan_pallas_v3(*map(jnp.asarray, arrays), k, metric, qt=qt,
                                         interpret=True)
    s2, got, _ = grouped_exact.grouped_scan_v3(*map(_t, arrays), k, metric, qt=qt)
    _agrees_with_pallas(s1, want, s2, got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_v2_on_the_split_product_matches_pallas(monkeypatch, metric):
    """grouped_scan_v2 with kernel K6 (mode id) replaced by its plain version
    on the split product, against grouped_scan_pallas (v2) in interpret
    mode."""
    monkeypatch.setattr(grouped_exact, "exact_scan", _on_split_product(exact_scan_plain))
    codes, ids, _, _, q, pids = _search_inputs(59)
    k, qt = 10, 8
    s1, want, _ = grouped_scan_pallas(*map(jnp.asarray, (codes, ids, q, pids)), k, metric, qt=qt,
                                      interpret=True)
    s2, got, _ = grouped_exact.grouped_scan_v2(*map(_t, (codes, ids, q, pids)), k, metric, qt=qt)
    _agrees_with_pallas(s1, want, s2, got)


def test_the_wrappers_take_the_f32_plain_versions_on_the_cpu():
    """On CPU tensors K1, K4, K5 and K6 run their f32 plain versions, not the
    model of the split product: nothing on a search path calls
    split_product."""
    inp = _k1_inputs(8, 256)
    args = (inp["gp"], inp["gsize"], inp["qg"], inp["codes"], inp["normsT"], 10,
            inp["slot_mult"], inp["levels"])
    assert torch.equal(grouped_scan.grouped_scan_kernel(*args), grouped_scan_plain(*args))
    for select in ("topk", "fold"):
        rargs = (inp["gp"], inp["gsize"], inp["q"], inp["codes"], inp["norms"], 10,
                 inp["slot_mult"], inp["levels"], "l2", select)
        for a, b in zip(rowscale_scan(*rargs), rowscale_scan_plain(*rargs)):
            assert torch.equal(a, b)
    ids = torch.arange(inp["norms"].numel(), dtype=torch.int32).reshape(inp["norms"].shape)
    for mode, kw in (("slot", dict(group_size=inp["gsize"], norms=inp["norms"])),
                     ("id", dict(ids=ids))):
        eargs = (inp["gp"], inp["q"], inp["codes"], 10, "l2", mode)
        for a, b in zip(grouped_exact.exact_scan(*eargs, **kw), exact_scan_plain(*eargs, **kw)):
            assert torch.equal(a, b)
    assert fold_rounds(torch.full((1, 128), -1.0), 2).tolist() == [[-1.0, -1.0]]
