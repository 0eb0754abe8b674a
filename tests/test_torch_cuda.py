"""quake_tpu_torch CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip where there is no CUDA device. They import
neither JAX nor the JAX package, so they also run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the pool merge (K2) is integer arithmetic and must be equal, as
must the grouping kernels' outputs to every bit (integer tables, and f32
operations in their plain version's order, each rounded alone). K1,
K3, K4 and K5 quantize f32 dot products with floor(); the kernel sums in
another order than torch.matmul, so a key can move by one level: they
compare winner overlap >= 0.99, and keys of a common winner within one
level. K4 and K5's per-row stats (rowmin, range) come from the same f32
scores summed in another order: rtol = atol = 1e-4. K6 selects on the f32
scores themselves and K7 on dequantized ones: scores rank by rank within
rtol = atol = 1e-4 (the other order of summation; K7's atol grows by one
quantization level, bounded by the largest possible score range / levels,
since that order can move a key by one level), winner overlap >= 0.99, and exact duplicates, whose scores tie bit for bit in either order
of summation, must come out in the kernel's tie order exactly. K8 writes raw
scores (rtol = atol = 1e-4, the same -inf lanes); sized_topk and multi_topk
select pairs like K6. K9's packed values carry the top bits of a score's bit
pattern, which the other order of summation moves in the last place: it is
held to winner overlap >= 0.99 against its plain version and to equality with
the top kk of K8's own scores, packed: K8 and K9 compute the same f32 scores
on the same body. Where K9 keeps its CUDA-core body (its lists crowd out the
tensor-core ring) and K8 runs the tensor cores, K9 is held to K8 run with
the depth padded by a zero column (D % 4 != 0: K8's CUDA-core body, the same
sums plus zero terms). K1, K4 and K5 on whole partitions, K6-K9, sized_topk
and multi_topk multiply on the tensor cores with split TF32 operands where
D % 4 == 0 and their tiles fit; they are held to their f32 plain versions
at the same tolerances (K1, K4-K9 and sized_topk also to the plain
versions run on ops/split_product.py's model of that product). K4 with a chunk table
multiplies in f32 on the CUDA cores. K1 on bf16 codes (its bf16 bodies) is held
to its plain version on the same bf16 operands (upcast, multiplied in f32:
each product exact, the sums in another order) at K1's tolerances.
"""

import contextlib

import numpy as np
import pytest
import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.flat_topk import (CUDA_CORE_BODY, KEPT_BODY, TWO_PASS_BODY, flat_topk,
                                           flat_topk_body, flat_topk_plain)
from quake_tpu_torch.ops.grouped_chunked import chunk_merge, chunk_merge_body, chunk_merge_plain
from quake_tpu_torch.ops.grouped_chunked import GROUP_BODY as K7_GROUP_BODY
from quake_tpu_torch.ops.grouped_chunked import MMA_BODY as K7_MMA_BODY
from quake_tpu_torch.ops.grouped_exact import GROUP_BODY as K6_GROUP_BODY
from quake_tpu_torch.ops.grouped_exact import MMA_BODY as K6_MMA_BODY
from quake_tpu_torch.ops.grouped_exact import exact_scan, exact_scan_plain, exact_topk_body
from quake_tpu_torch.ops.grouped_family import (CHUNK_BODY, GROUP_BODY, MMA_BODY,
                                                rowscale_fold_body, rowscale_scan,
                                                rowscale_scan_plain, rowscale_topk_body)
from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                              grouped_scan_uses_mma,
                                              merge_positions, merge_positions_plain,
                                              packed_params)
from quake_tpu_torch.ops.split_product import bmm_as_split_product
from quake_tpu_torch.ops.grouped_variants import CUDA_CORE_BODY as MULTI_CUDA_CORE_BODY
from quake_tpu_torch.ops.grouped_variants import MMA_BODY as MULTI_MMA_BODY
from quake_tpu_torch.ops.grouped_variants import (grouped_scan_multi, grouped_scan_sized,
                                                  multi_topk, multi_topk_body, multi_topk_plain,
                                                  pack_scores, packed_topk, packed_topk_body,
                                                  packed_topk_plain, raw_scores, raw_scores_body,
                                                  raw_scores_plain, sized_topk, sized_topk_body,
                                                  sized_topk_plain, slot_bits_of)
from quake_tpu_torch.ops.grouped_family import grouped_scan_v8
from quake_tpu_torch.storage.store import PartitionStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _overlap(a, b):
    tot = 0.0
    for ra, rb in zip(a.tolist(), b.tolist()):
        sa, sb = {v for v in ra if v >= 0}, {v for v in rb if v >= 0}
        tot += len(sa & sb) / len(sb) if sb else float(not sa)
    return tot / a.shape[0]


@pytest.mark.parametrize("qt,D,C", [(8, 16, 128), (16, 13, 256), (32, 32, 384), (64, 128, 256)])
def test_grouped_scan_kernel_matches_plain(dev, qt, D, C):
    rng = np.random.default_rng(qt + D)
    P, Gn, kk = 6, 20, 10
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(rng.integers(0, C + 1, P).astype(np.int32)).to(dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    slot_mult, levels = packed_params(C)
    scale = levels / 200.0
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32) * scale).to(dev)
    normsT = ((codes * codes).sum(-1) * 0.5 - 100.0) * scale
    got = grouped_scan_kernel(gp, gsize.contiguous(), qg, codes, normsT.contiguous(), kk,
                              slot_mult, levels)
    want = grouped_scan_plain(gp, gsize, qg, codes, normsT, kk, slot_mult, levels)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    gl = torch.where(g >= 0, torch.remainder(g, slot_mult), torch.full_like(g, -1))
    wl = torch.where(w >= 0, torch.remainder(w, slot_mult), torch.full_like(w, -1))
    assert _overlap(gl, wl) >= 0.99
    # Where both pick the same lane, its key moved by at most one level.
    same = (gl == wl) & (gl >= 0)
    key_diff = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    assert float(key_diff[same].max()) <= 1.0


@pytest.mark.parametrize("poolp,kfin", [(128, 10), (256, 10), (1280, 20), (90, 10), (91, 10),
                                        (92, 10)])
def test_merge_positions_kernel_matches_plain(dev, poolp, kfin):
    """K2 on the placed pool as it is: widths that take 8- and 4-byte loads,
    one fold segment or several."""
    rng = np.random.default_rng(poolp)
    slot_mult = 256
    keys = rng.integers(-1, 500, size=(1000, poolp)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.4] = -1.0
    slots = rng.integers(0, slot_mult, size=keys.shape).astype(np.float32)
    m_packed = torch.from_numpy(np.where(keys >= 0, keys * slot_mult + slots, -1.0)
                                .astype(np.float32)).to(dev)
    got = merge_positions(m_packed, kfin, slot_mult)
    want = merge_positions_plain(m_packed, kfin, slot_mult)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,k", [(256, 300), (768, 150)])
def test_flat_topk_more_rounds_than_a_staging_row(dev, N, k):
    """K3 stages the rounds' winners in rows of its score tile (N + 8 floats
    with the scores kept, 136 in two passes) and writes them out a row's
    width at a time: k past that width takes several stagings."""
    rng = np.random.default_rng(N + k)
    B, D = 200, 64
    codes = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    ok = torch.arange(N, device=dev) < N - 30
    bias = torch.where(ok, -(codes * codes).sum(1), torch.full((N,), float("-inf"), device=dev))
    got = flat_topk(codes, bias.contiguous(), q, k, "l2")
    want = flat_topk_plain(codes, bias.contiguous(), q, k, "l2")
    torch.cuda.synchronize()
    assert not (got >= N - 30).any()
    assert _overlap(got, want) >= 0.99
    assert torch.equal(got < 0, want < 0)


def _flat_keys(codes, bias, q, metric):
    """The plain version's quantized key of every (query, slot)."""
    from quake_tpu_torch.ops.flat_topk import _packed_params

    _, levels = _packed_params(codes.shape[0])
    prod = q @ codes.T
    s = (2.0 * prod if metric == "l2" else prod) + bias[None, :]
    valid = s > float("-inf")
    mx = torch.where(valid, s, torch.full_like(s, float("-inf"))).amax(1, keepdim=True)
    mn = torch.where(valid, s, torch.full_like(s, float("inf"))).amin(1, keepdim=True)
    return torch.floor((s - mn) * (levels / torch.clamp(mx - mn, min=1e-20)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("N,D,B", [(256, 128, 1000), (384, 13, 1000), (256, 768, 300),
                                   (16384, 128, 300), (640, 100, 200), (768, 36, 200),
                                   (256, 130, 100), (256, 770, 200)])
def test_flat_topk_kernel_matches_plain(dev, metric, N, D, B):
    """K3 against its plain version: the tensor-core body with the scores
    kept (N up to 640) and in two passes (N = 768, 16384), a depth that
    streams in chunks (D = 768), and the CUDA-core body (D = 13; in depth
    chunks, D = 130 and 770). Winner overlap >= 0.99, and rank by rank the
    picks' keys within one level."""
    rng = np.random.default_rng(N + D)
    k = 16
    codes = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    ok = torch.arange(N, device=dev) < N - 30
    base = -(codes * codes).sum(1) if metric == "l2" else torch.zeros(N, device=dev)
    bias = torch.where(ok, base, torch.full_like(base, float("-inf"))).contiguous()
    got = flat_topk(codes, bias, q, k, metric)
    want = flat_topk_plain(codes, bias, q, k, metric)
    torch.cuda.synchronize()
    assert not (got >= N - 30).any()
    assert _overlap(got, want) >= 0.99
    key = _flat_keys(codes, bias, q, metric)
    both = (got >= 0) & (want >= 0)
    kg = torch.gather(key, 1, got.clamp(min=0).long())
    kw = torch.gather(key, 1, want.clamp(min=0).long())
    assert float((kg - kw).abs()[both].max()) <= 1.0


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 10), (64, 10), (8, 100), (64, 100)])
@pytest.mark.parametrize("select,C", [("topk", 200), ("topk", 384), ("fold", 384)])
def test_rowscale_kernels_match_plain(dev, select, C, qt, kk, metric):
    """K4 (exact per-row top-kk; odd C included) and K5 (fold-128) with ghost
    groups, an empty partition, one-lane rows and partitions below kk."""
    rng = np.random.default_rng(C + qt + kk)
    P, Gn, D = 6, 24, 32
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(C)
    args = (gp, gsize.contiguous(), qg, codes, norms, kk, slot_mult, levels, metric, select)
    got, got_stats = rowscale_scan(*args)
    want, want_stats = rowscale_scan_plain(*args)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    assert (got_stats[~alive][:, :, 0] == 0).all()
    assert (got_stats[~alive][:, :, 1] == np.float32(1e-20)).all()
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    gl = torch.where(g >= 0, torch.remainder(g, slot_mult), torch.full_like(g, -1))
    wl = torch.where(w >= 0, torch.remainder(w, slot_mult), torch.full_like(w, -1))
    assert _overlap(gl, wl) >= 0.99
    same = (gl == wl) & (gl >= 0)
    key_diff = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    assert float(key_diff[same].max()) <= 1.0
    assert ((g >= 0).sum(1) == (w >= 0).sum(1)).all()  # as many winners as valid lanes


def test_rowscale_topk_rejects_kk_beyond_shared_memory(dev):
    C, D, qt, kk = 1024, 128, 64, 1000
    codes = torch.zeros((2, C, D), device=dev)
    gp = torch.zeros(4, dtype=torch.int32, device=dev)
    slot_mult, levels = packed_params(C)
    with pytest.raises(ValueError, match="shared memory"):
        rowscale_scan(gp, gp + C, torch.zeros((4, qt, D), device=dev), codes,
                      torch.zeros((2, C), device=dev), kk, slot_mult, levels, "l2")


def _chunk_store(dev, rng, P, C, D, kk):
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], dtype=torch.int32, device=dev)
    return codes, norms, sizes


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 10), (64, 10), (64, 100)])
@pytest.mark.parametrize("C,ct", [(384, 128), (512, 256), (200, 100)])
def test_rowscale_chunk_table_matches_plain(dev, C, ct, qt, kk, metric):
    """K4 with a chunk table (the v4 scan): every chunk of every partition
    as its own group, shared query tiles, chunks past the size, ghosts."""
    rng = np.random.default_rng(C + qt + kk)
    P, G, D = 6, 5, 32
    codes, norms, sizes = _chunk_store(dev, rng, P, C, D, kk)
    maxch = C // ct
    gp = torch.arange(-1, P, dtype=torch.int32, device=dev).repeat_interleave(maxch)
    chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(P + 1)
    gsize = torch.where(gp >= 0, (sizes[gp.clamp(min=0).long()] - chunk * ct).clamp(0, ct),
                        torch.zeros_like(gp)).contiguous()
    qsrc = torch.from_numpy(rng.integers(0, G, gp.shape[0]).astype(np.int32)).to(dev)
    qg = torch.from_numpy(rng.standard_normal((G, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(ct)
    kw = dict(qsrc=qsrc, row_off=(chunk * ct).contiguous(), ct=ct)
    args = (gp.contiguous(), gsize, qg, codes, norms, min(kk, ct), slot_mult, levels, metric,
            "topk")
    got, got_stats = rowscale_scan(*args, **kw)
    want, want_stats = rowscale_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    g, w = got[alive].reshape(-1, got.shape[2]), want[alive].reshape(-1, got.shape[2])
    gl = torch.where(g >= 0, torch.remainder(g, slot_mult), torch.full_like(g, -1))
    wl = torch.where(w >= 0, torch.remainder(w, slot_mult), torch.full_like(w, -1))
    assert _overlap(gl, wl) >= 0.99
    same = (gl == wl) & (gl >= 0)
    key_diff = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    assert float(key_diff[same].max()) <= 1.0
    assert ((g >= 0).sum(1) == (w >= 0).sum(1)).all()


def _pairs_match(got_s, got_i, want_s, want_i, tol, level=0.0):
    """(score, index) lists rank by rank: as many winners, scores within
    rtol = tol and atol = tol + level, winner overlap >= 0.99."""
    assert ((got_i >= 0) == (want_i >= 0)).all()
    assert (torch.isneginf(got_s) == (got_i < 0)).all()
    ok = want_i >= 0
    torch.testing.assert_close(got_s[ok], want_s[ok], rtol=tol, atol=tol + level)
    assert _overlap(got_i.reshape(-1, got_i.shape[-1]), want_i.reshape(-1, got_i.shape[-1])) >= 0.99
    step = torch.diff(got_s, dim=-1)
    assert (step[~torch.isnan(step)] <= 0).all()  # descending (-inf next to -inf gives nan)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 1), (64, 10), (8, 40), (64, 128)])
@pytest.mark.parametrize("mode,C", [("slot", 200), ("slot", 384), ("id", 200), ("id", 384)])
def test_exact_topk_kernel_matches_plain(dev, mode, C, qt, kk, metric):
    """K6 in both modes: odd C, ghost groups, an empty partition, partitions
    below kk, and duplicate vectors whose equal scores must order by the
    larger slot (mode slot) or the larger id (mode id)."""
    rng = np.random.default_rng(C + qt + kk)
    P, Gn, D = 6, 24, 32
    codes, norms, sizes = _chunk_store(dev, rng, P, C, D, kk)
    codes[0, 5::2] = codes[0, 5]  # many copies of one vector in partition 0
    codes[1, 10] = codes[1, 90]
    norms = (codes * codes).sum(-1).contiguous()
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    lane = torch.arange(C, device=dev)[None, :]
    ids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:2] = torch.tensor([0, 1], dtype=torch.int32)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 5] * 3.0  # the copies are this row's best
    kw = dict(group_size=gsize, norms=norms) if mode == "slot" else dict(ids=ids)
    got_s, got_i = exact_scan(gp, qg, codes, min(kk, C), metric, mode, **kw)
    want_s, want_i = exact_scan_plain(gp, qg, codes, min(kk, C), metric, mode, **kw)
    torch.cuda.synchronize()
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    # Runs of equal scores (the copies) come out index-descending.
    tied = torch.diff(got_s, dim=2) == 0
    assert bool(tied.any()) or kk == 1
    assert (torch.diff(got_i, dim=2)[tied & (got_i[:, :, 1:] >= 0)] < 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 10), (64, 10), (8, 64)])
@pytest.mark.parametrize("C,ct", [(384, 128), (512, 256), (256, 64)])
def test_chunk_merge_kernel_matches_plain(dev, C, ct, qt, kk, metric):
    """K7: chunks of one and of two 128-row segments and below one, ghost
    groups, an empty partition, partitions that end inside a chunk."""
    rng = np.random.default_rng(C + qt + kk)
    P, Gn, D = 6, 24, 32
    codes, norms, sizes = _chunk_store(dev, rng, P, C, D, kk)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(ct)
    args = (gp, gsize, qg, codes, norms, min(kk, ct), ct, slot_mult, levels, metric)
    got_s, got_i = chunk_merge(*args)
    want_s, want_i = chunk_merge_plain(*args)
    torch.cuda.synchronize()
    # One key level is at most (the largest possible score range) / levels.
    qmax, xmax = float((qg * qg).sum(-1).max().sqrt()), float(norms.max().sqrt())
    span = 4.0 * qmax * xmax + xmax * xmax if metric == "l2" else 2.0 * qmax * xmax
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4, level=span / levels)


def test_exact_and_chunk_kernels_reject_kk_beyond_shared_memory(dev):
    C, D, qt = 1024, 128, 64
    codes = torch.zeros((2, C, D), device=dev)
    gp = torch.zeros(4, dtype=torch.int32, device=dev)
    qg, norms = torch.zeros((4, qt, D), device=dev), torch.zeros((2, C), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        exact_scan(gp, qg, codes, 512, "l2", "slot", group_size=gp + C, norms=norms)
    with pytest.raises(ValueError, match="shared memory"):
        chunk_merge(gp, gp + C, qg, codes, norms, 128, 256, 256, 65534, "l2")


def _variant_store(dev, rng, C, kk, P=6, Gn=24, D=32):
    """Store, ids (-1 past each size), sizes and groups (ghosts included)
    for the kernels of the approx, sized, packed and multi scans."""
    codes, _, sizes = _chunk_store(dev, rng, P, C, D, kk)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    lane = torch.arange(C, device=dev)[None, :]
    ids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:2] = torch.tensor([0, 1], dtype=torch.int32)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    return codes, ids, gp, gsize


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D,C", [(8, 16, 128), (16, 13, 200), (32, 32, 384), (64, 128, 256)])
def test_raw_scores_kernel_matches_plain(dev, qt, D, C, metric):
    """K8: odd C and D, ghost groups, an empty partition, -inf at lanes
    without an id."""
    rng = np.random.default_rng(qt + C)
    codes, ids, gp, _ = _variant_store(dev, rng, C, 10, D=D)
    qg = torch.from_numpy(rng.standard_normal((gp.shape[0], qt, D)).astype(np.float32)).to(dev)
    got = raw_scores(gp, qg, codes, ids, metric)
    want = raw_scores_plain(gp, qg, codes, ids, metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isneginf(got[gp < 0]).all() and torch.isfinite(got).any()
    ok = torch.isfinite(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-4, atol=1e-4)


def _k8_as_k9(gp, qg, codes, ids, kk, metric):
    """K8's scores in the arithmetic of the body K9 runs at this shape, and
    that body: K8 itself where both launchers pick one body; where K9 keeps
    its CUDA-core body and K8 takes the tensor cores, K8 with the depth
    padded by a zero column (D % 4 != 0: its CUDA-core body)."""
    qt, D = qg.shape[1], qg.shape[2]
    body = packed_topk_body(qt, D, kk, codes.dtype)
    if raw_scores_body(qt, D, codes.dtype) == body:
        return raw_scores(gp, qg, codes, ids, metric), body
    assert raw_scores_body(qt, D + 1, codes.dtype) == body == MULTI_CUDA_CORE_BODY
    qg1, codes1 = (torch.nn.functional.pad(t, (0, 1)).contiguous() for t in (qg, codes))
    return raw_scores(gp, qg1, codes1, ids, metric), body


def _k9_agree(got, want, raw, bits, exact=True):
    """K9 against a plain version: as many winners per row, strictly
    descending, -1 tails, winner overlap >= 0.99; with exact, equal to the
    top kk of raw (K8's scores in K9's arithmetic), packed."""
    kk = got.shape[-1]
    assert ((got >= 0) == (want >= 0)).all() and (got >= -1).all()
    assert (torch.diff(got, dim=2)[got[:, :, 1:] >= 0] < 0).all()
    mask = (1 << bits) - 1
    gl = torch.where(got >= 0, got & mask, torch.full_like(got, -1)).reshape(-1, kk)
    wl = torch.where(want >= 0, want & mask, torch.full_like(want, -1)).reshape(-1, kk)
    shared = ((gl[:, :, None] == wl[:, None, :]) & (gl[:, :, None] >= 0)).any(2).sum(1)
    n = (wl >= 0).sum(1)
    share = torch.where(n > 0, shared / n.clamp(min=1), ((gl >= 0).sum(1) == 0).double())
    assert float(share.double().mean()) >= 0.99
    if exact:
        ref = torch.where(torch.isneginf(raw), -1, pack_scores(raw, bits))
        assert torch.equal(torch.topk(ref, kk, dim=2).values, got)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 1), (64, 10), (8, 40), (64, 384)])
@pytest.mark.parametrize("C", [200, 512])
def test_packed_topk_kernel_matches_plain(dev, C, qt, kk, metric):
    """K9, up to the largest kk that fits shared memory at qt = 64, D = 32:
    the tensor-core body up to kk = 98 there, the CUDA-core body past it, each
    equal to the top kk of K8's scores in its own arithmetic, packed."""
    rng = np.random.default_rng(C + qt + kk)
    kk = min(kk, C)
    codes, ids, gp, _ = _variant_store(dev, rng, C, kk)
    codes[0, 5::2] = codes[0, 5]  # equal scores still pack to distinct values
    qg = torch.from_numpy(rng.standard_normal((gp.shape[0], qt, 32)).astype(np.float32)).to(dev)
    got = packed_topk(gp, qg, codes, ids, kk, metric)
    want = packed_topk_plain(gp, qg, codes, ids, kk, metric)
    raw, body = _k8_as_k9(gp, qg, codes, ids, kk, metric)
    torch.cuda.synchronize()
    assert body == (MULTI_MMA_BODY if kk <= 98 else MULTI_CUDA_CORE_BODY)
    assert (got[gp < 0] == -1).all()
    _k9_agree(got, want, raw, slot_bits_of(C))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 1), (64, 10), (8, 40), (64, 128)])
@pytest.mark.parametrize("C,ct", [(200, 64), (384, 256), (512, 128)])
def test_sized_topk_kernel_matches_plain(dev, C, ct, qt, kk, metric):
    """sized_topk: tile heights that do and do not divide C, poisoned rows
    past the size (reaching no output), kk = 1 and the largest kk that
    fits."""
    rng = np.random.default_rng(C + qt + kk)
    codes, _, gp, gsize = _variant_store(dev, rng, C, kk)
    lane = torch.arange(C, device=dev)[None, :, None]
    sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], device=dev)
    codes = torch.where(lane < sizes[:, None, None], codes, torch.full_like(codes, 999.0))
    qg = torch.from_numpy(rng.standard_normal((gp.shape[0], qt, 32)).astype(np.float32)).to(dev)
    got_s, got_i = sized_topk(gp, gsize, qg, codes, min(kk, C), metric, ct=ct)
    want_s, want_i = sized_topk_plain(gp, gsize, qg, codes, min(kk, C), metric, ct=ct)
    torch.cuda.synchronize()
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    assert (got_i < gsize[:, None, None]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,kk", [(8, 1), (64, 10), (8, 40), (64, 128)])
@pytest.mark.parametrize("C,gb", [(200, 1), (384, 3), (512, 8)])
def test_multi_topk_kernel_matches_plain(dev, C, gb, qt, kk, metric):
    """multi_topk: gb groups per block (24 groups: gb in 1, 3, 8), copies of
    one vector whose equal scores must order by the smaller slot."""
    rng = np.random.default_rng(C + qt + kk)
    codes, ids, gp, _ = _variant_store(dev, rng, C, kk)
    codes[0, 5::2] = codes[0, 5]
    qg = torch.from_numpy(rng.standard_normal((gp.shape[0], qt, 32)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 5] * 3.0  # the copies are this row's best
    got_s, got_i = multi_topk(gp, qg, codes, ids, min(kk, C), metric, gb=gb)
    want_s, want_i = multi_topk_plain(gp, qg, codes, ids, min(kk, C), metric)
    torch.cuda.synchronize()
    assert ((got_i == C) == torch.isneginf(got_s)).all()
    got_i, want_i = got_i.masked_fill(got_i >= C, -1), want_i.masked_fill(want_i >= C, -1)
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    tied = torch.diff(got_s, dim=2) == 0
    assert bool(tied.any()) or kk == 1
    assert (torch.diff(got_i, dim=2)[tied & (got_i[:, :, 1:] >= 0)] > 0).all()


def test_variant_kernels_at_the_largest_kk_and_one_past(dev):
    """qt = 64, D = 128: 128 pairs, or 384 packed values, per row are the most
    that fit a block's shared memory (K9 there on its CUDA-core body, held to
    K8 on a zero-padded depth); they agree with the plain versions, and one
    more raises."""
    rng = np.random.default_rng(11)
    C, D, qt = 1024, 128, 64
    codes = torch.from_numpy(rng.standard_normal((2, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(2 * C).astype(np.int32).reshape(2, C)).to(dev)
    ids[1, 900:] = -1
    gp = torch.tensor([0, 1, -1, 1], dtype=torch.int32, device=dev)
    gsize = torch.tensor([C, 900, 0, 900], dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((4, qt, D)).astype(np.float32)).to(dev)
    _pairs_match(*sized_topk(gp, gsize, qg, codes, 128, "l2"),
                 *sized_topk_plain(gp, gsize, qg, codes, 128, "l2"), 1e-4)
    got_s, got_i = multi_topk(gp, qg, codes, ids, 128, "l2", gb=2)
    want_s, want_i = multi_topk_plain(gp, qg, codes, ids, 128, "l2")
    _pairs_match(got_s, got_i.masked_fill(got_i >= C, -1), want_s,
                 want_i.masked_fill(want_i >= C, -1), 1e-4)
    got = packed_topk(gp, qg, codes, ids, 384, "l2")
    raw, body = _k8_as_k9(gp, qg, codes, ids, 384, "l2")
    torch.cuda.synchronize()
    assert body == MULTI_CUDA_CORE_BODY
    _k9_agree(got, packed_topk_plain(gp, qg, codes, ids, 384, "l2"), raw, slot_bits_of(C))
    with pytest.raises(ValueError, match="shared memory"):
        sized_topk(gp, gsize, qg, codes, 129, "l2")
    with pytest.raises(ValueError, match="shared memory"):
        multi_topk(gp, qg, codes, ids, 129, "l2", gb=2)
    with pytest.raises(ValueError, match="shared memory"):
        packed_topk(gp, qg, codes, ids, 385, "l2")


def test_launch_counts(dev):
    _ext.reset_launches()
    m_packed = torch.zeros((8, 90), device=dev)
    merge_positions(m_packed, 4, 128)
    merge_positions_plain(m_packed, 4, 128)
    gp = torch.zeros(2, dtype=torch.int32, device=dev)
    qg, codes = torch.zeros((2, 8, 16), device=dev), torch.zeros((1, 128, 16), device=dev)
    ids = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    raw_scores(gp, qg, codes, ids, "l2")
    raw_scores_plain(gp, qg, codes, ids, "l2")
    sized_topk(gp, gp + 100, qg, codes, 4, "ip")
    multi_topk(gp, qg, codes, ids, 4, "ip", gb=2)
    packed_topk(gp, qg, codes, ids, 4, "ip")
    # On bf16 codes each counts under its own name, the f32 counts unchanged.
    qb, cb = qg.to(torch.bfloat16), codes.to(torch.bfloat16)
    raw_scores(gp, qb, cb, ids, "l2")
    sized_topk(gp, gp + 100, qb, cb, 4, "ip")
    multi_topk(gp, qb, cb, ids, 4, "ip", gb=2)
    packed_topk(gp, qb, cb, ids, 4, "ip")
    assert _ext.launches == {"grouped_scan": 0, "grouped_scan_bf16": 0, "grouped_scan_budget": 0,
                             "grouped_scan_budget_bf16": 0, "merge_positions": 1,
                             "flat_topk": 0,
                             "rowscale_topk": 0, "rowscale_fold": 0, "exact_topk": 0,
                             "chunk_merge": 0, "raw_scores": 1, "packed_topk": 1,
                             "sized_topk": 1, "multi_topk": 1, "flat_topk_bf16": 0,
                             "rowscale_topk_bf16": 0, "rowscale_fold_bf16": 0,
                             "exact_topk_bf16": 0, "chunk_merge_bf16": 0, "raw_scores_bf16": 1,
                             "packed_topk_bf16": 1, "sized_topk_bf16": 1, "multi_topk_bf16": 1,
                             "group_count": 0, "group_scan": 0, "group_scatter": 0,
                             "group_tables": 0}


# ------------------------------------------- K1 and K4 on the tensor cores

# Sizes that stress the 128-row segment tiles: empty, one lane, one short of a
# segment, a whole one, one past it, and the full partition.
def _tile_sizes(C):
    return [0, 1, 127, 128, 129, C]


def _packed_agree(got, want, alive, slot_mult, kk):
    """Winner overlap >= 0.99, keys of common winners within one level, as
    many winners per row."""
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    gl = torch.where(g >= 0, torch.remainder(g, slot_mult), torch.full_like(g, -1))
    wl = torch.where(w >= 0, torch.remainder(w, slot_mult), torch.full_like(w, -1))
    assert _overlap(gl, wl) >= 0.99
    same = (gl == wl) & (gl >= 0)
    key_diff = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    assert not same.any() or float(key_diff[same].max()) <= 1.0
    assert ((g >= 0).sum(1) == (w >= 0).sum(1)).all()


@pytest.mark.parametrize("kk", [1, 10, 100])
@pytest.mark.parametrize("D", [24, 100, 128, 200, 256])
@pytest.mark.parametrize("qt", [8, 64])
def test_grouped_scan_tensor_core_tiles(dev, qt, D, kk):
    """K1's tensor-core body: more groups than blocks (each block walks several
    groups and prefetches across their borders), D below and at the tile
    depth and beyond it (200, 256: a ring stage holds a depth chunk and the
    accumulator carries over the chunks), sizes around a segment, ghosts;
    against the f32 plain version and against the plain version on the split
    product."""
    assert grouped_scan_uses_mma(qt, D)
    rng = np.random.default_rng(qt + D + kk)
    C, Gn = 512, 300
    sizes_l = _tile_sizes(C)
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    slot_mult, levels = packed_params(C)
    scale = levels / (10.0 * D ** 0.5)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32) * scale).to(dev)
    normsT = (((codes * codes).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
    args = (gp, gsize, qg, codes, normsT, kk, slot_mult, levels)
    got = grouped_scan_kernel(*args)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    assert (got[alive] >= -1).all() and torch.isfinite(got).all()
    _packed_agree(got, grouped_scan_plain(*args), alive, slot_mult, kk)
    with bmm_as_split_product():
        _packed_agree(got, grouped_scan_plain(*args), alive, slot_mult, kk)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 100])
@pytest.mark.parametrize("D", [24, 100, 128, 200, 256])
@pytest.mark.parametrize("qt", [8, 64])
def test_rowscale_topk_tensor_core_tiles(dev, qt, D, kk, metric):
    """K4's tensor-core body (whole partitions): more groups than blocks, a C
    that no segment divides, sizes around a segment (one segment: selected
    from the accumulator; two: the ring keeps the first where a stage holds
    all of D), D beyond a stage's depth (200, 256), ghosts."""
    assert rowscale_topk_body(qt, D, kk) == MMA_BODY
    rng = np.random.default_rng(qt + D + kk)
    C, Gn = 520, 300
    sizes_l = _tile_sizes(C) + [256, 300]
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(C)
    args = (gp, gsize, qg, codes, norms, kk, slot_mult, levels, metric, "topk")
    got, got_stats = rowscale_scan(*args)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    assert (got_stats[~alive][:, :, 0] == 0).all()
    assert (got_stats[~alive][:, :, 1] == np.float32(1e-20)).all()
    for model in (False, True):
        with bmm_as_split_product() if model else contextlib.nullcontext():
            want, want_stats = rowscale_scan_plain(*args)
        torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
        _packed_agree(got, want, alive, slot_mult, kk)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D,kk", [(8, 24, 1), (64, 128, 10), (64, 100, 100), (8, 128, 10)])
@pytest.mark.parametrize("C,ct", [(512, 128), (520, 128), (512, 256), (700, 256)])
def test_rowscale_topk_tensor_core_chunk_table(dev, C, ct, qt, D, kk, metric):
    """K4's persistent body for a chunk table laid out as the v4 scan lays
    it: the chunks of one (partition, query tile) group consecutive and
    sharing qsrc, more chunk-groups than blocks, partitions ending inside a
    chunk and chunks past the size (ghosts), a last chunk cut by C. It
    multiplies in f32 in the plain version's order: the stats are equal."""
    assert rowscale_topk_body(qt, D, min(kk, ct), chunked=True) == CHUNK_BODY
    rng = np.random.default_rng(C + ct + qt + D)
    sizes_l = _tile_sizes(C) + [ct + 1, C - 3]
    P, G = len(sizes_l), 60
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    maxch = -(-C // ct)
    pid = torch.from_numpy(rng.integers(-1, P, G).astype(np.int32)).to(dev)
    gp = pid.repeat_interleave(maxch).contiguous()
    chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(G)
    gsize = torch.where(gp >= 0, (sizes[gp.clamp(min=0).long()] - chunk * ct).clamp(0, ct),
                        torch.zeros_like(gp)).contiguous()
    qsrc = torch.arange(G, dtype=torch.int32, device=dev).repeat_interleave(maxch).contiguous()
    qg = torch.from_numpy(rng.standard_normal((G, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(ct)
    kw = dict(qsrc=qsrc, row_off=(chunk * ct).contiguous(), ct=ct)
    args = (gp, gsize, qg, codes, norms, min(kk, ct), slot_mult, levels, metric, "topk")
    got, got_stats = rowscale_scan(*args, **kw)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    want, want_stats = rowscale_scan_plain(*args, **kw)
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    _packed_agree(got, want, alive, slot_mult, min(kk, ct))


@pytest.mark.parametrize("D", [13, 24, 30, 100, 128, 132, 256, 300])
@pytest.mark.parametrize("qt", [8, 16, 32, 64])
def test_launchers_pick_the_body_by_shape(dev, qt, D):
    """The launchers run K1's and K4's CUDA-core bodies only where a row is
    not 16-byte aligned (D % 4 != 0) and, K4, with a chunk table; the
    tensor-core bodies everywhere else (D past a ring stage's depth streams
    through it in chunks)."""
    for kk in (1, 10, 100):
        assert rowscale_topk_body(qt, D, kk, chunked=True) in (CHUNK_BODY, GROUP_BODY)
        assert rowscale_topk_body(qt, D, kk) == (GROUP_BODY if D % 4 else MMA_BODY)
    assert grouped_scan_uses_mma(qt, D) == (D % 4 == 0)
    if D <= 128:  # the chunk-table body's two segment buffers fit at every qt
        assert rowscale_topk_body(qt, D, 100, chunked=True) == CHUNK_BODY


@pytest.mark.parametrize("qt,D,serves", [
    (64, 608, True), (64, 768, False), (32, 768, True), (32, 1408, True), (32, 1412, False),
    (64, 300, True), (64, 302, False), (32, 302, False), (8, 770, False), (8, 424, True),
])
def test_grouped_scan_serves_each_shape(dev, qt, D, serves):
    """Which body of K1 serves (qt, D): the tensor-core body (`serves`) where
    D % 4 == 0 and the whole-D query tile fits beside a ring stage, else the
    CUDA-core body, which streams D in depth chunks and serves every shape.
    The index lowers qt to the largest height the tensor-core body serves."""
    assert grouped_scan_uses_mma(qt, D) == serves
    if D % 4:
        assert not serves


@pytest.mark.parametrize("qt,D", [(64, 130), (64, 770), (8, 770), (32, 13)])
def test_grouped_scan_cuda_core_body_streams_depth(dev, qt, D):
    """K1's CUDA-core body (D % 4 != 0) at depths of one chunk (D = 13) and
    of several (D = 130, 770), at every query-tile height: same function as
    its plain version."""
    rng = np.random.default_rng(qt * D)
    P, C, Gn, kk = 6, 256, 40, 10
    assert not grouped_scan_uses_mma(qt, D)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    sizes = torch.tensor(_tile_sizes(C), dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    slot_mult, levels = packed_params(C)
    q = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    scale = levels / (10.0 * D ** 0.5)
    normsT = (((codes * codes).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
    args = (gp, gsize, (q * scale).contiguous(), codes, normsT, kk, slot_mult, levels)
    got = grouped_scan_kernel(*args)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    _packed_agree(got, grouped_scan_plain(*args), alive, slot_mult, kk)


@pytest.mark.parametrize("N,D,body", [
    (256, 128, KEPT_BODY), (640, 128, KEPT_BODY), (768, 128, TWO_PASS_BODY),
    (16384, 128, TWO_PASS_BODY), (256, 768, KEPT_BODY), (256, 4096, KEPT_BODY),
    (384, 13, CUDA_CORE_BODY), (256, 770, CUDA_CORE_BODY),
])
def test_flat_topk_body_by_shape(dev, N, D, body):
    """K3's body by shape: every D is served (both bodies stream the depth)."""
    assert flat_topk_body(N, D) == body


@pytest.mark.parametrize("D", [768, 770])
def test_wide_vectors_search_on_the_card(dev, D):
    """The default fused search at D = 768 (K1's tensor-core body at qt = 32,
    K3's streaming the depth) and D = 770 (the CUDA-core bodies of K1 and
    K3, both streaming the depth) agrees with the exact scan of the probed
    partitions."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.coordinator import rank_parents, reference_scan

    rng = np.random.default_rng(D)
    x = rng.standard_normal((8192, D)).astype(np.float32)
    q = x[:64] + 0.1 * rng.standard_normal((64, D)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=8, calibrate_aps=False))
    sp = SearchParams(k=10, nprobe=6)
    qt = idx._grouped_params(64, 6)[0]
    mma = [t for t in (64, 32, 16, 8) if grouped_scan_uses_mma(t, D)]
    assert mma == ([32, 16, 8] if D == 768 else [])
    assert qt in (mma if D == 768 else (64, 32, 16, 8))
    assert idx._grouped_kernel().startswith("v11g")
    _ext.reset_launches()
    res = idx.search(q, sp)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    assert launches["flat_topk"] == 1
    assert launches["grouped_scan"] == 1 and launches["merge_positions"] == 1
    st, pst = idx.store.state, idx.parent.store.state
    qd = torch.from_numpy(q).to(dev)
    pids = rank_parents(pst.codes, pst.ids, pst.norms, qd, 6, "l2", "pallas")
    _, want, _ = reference_scan(st.codes, st.ids, st.norms, qd, pids, 10, "l2")
    assert res.ids.shape == (64, 10) and np.isfinite(res.distances).all()
    assert _overlap(torch.from_numpy(res.ids), want.cpu().long()) >= 0.99


@pytest.mark.parametrize("D", [13, 30])
def test_cuda_core_bodies_still_match_plain(dev, D):
    """D % 4 != 0 takes K1's and K4's CUDA-core bodies: same function."""
    rng = np.random.default_rng(D)
    P, C, Gn, qt, kk = 6, 256, 150, 32, 10
    assert not grouped_scan_uses_mma(qt, D) and rowscale_topk_body(qt, D, kk) == GROUP_BODY
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor(_tile_sizes(C), dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    slot_mult, levels = packed_params(C)
    q = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    alive = gsize > 0
    scale = levels / (10.0 * D ** 0.5)
    normsT = (((codes * codes).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
    args = (gp, gsize, (q * scale).contiguous(), codes, normsT, kk, slot_mult, levels)
    _packed_agree(grouped_scan_kernel(*args), grouped_scan_plain(*args), alive, slot_mult, kk)
    args = (gp, gsize, q, codes, norms, kk, slot_mult, levels, "l2", "topk")
    got, got_stats = rowscale_scan(*args)
    want, want_stats = rowscale_scan_plain(*args)
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    _packed_agree(got, want, alive, slot_mult, kk)


# ------------------------------------------- K7 and multi_topk on the tensor cores


def _k7_case(dev, rng, C, ct, qt, D, kk, metric, Gn=40):
    """K7's inputs over partitions that fill the slab, end inside a chunk,
    leave a chunk of one valid lane, hold one lane, are empty, and ghost
    groups (pid -1, or a live pid with size 0)."""
    P = 6
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor([C, C - ct // 2 - 3, 0, ct + 1, 1, ct // 2 + 7], dtype=torch.int32,
                         device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:P] = torch.arange(P, dtype=torch.int32)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    gsize[P] = 0  # a live pid the caller gives no rows: a ghost too
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(ct)
    return (gp, gsize.contiguous(), qg, codes, norms, kk, ct, slot_mult, levels, metric)


def _k7_agree(args):
    got_s, got_i = chunk_merge(*args)
    want_s, want_i = chunk_merge_plain(*args)
    torch.cuda.synchronize()
    gp, gsize, qg, norms, levels, metric = args[0], args[1], args[2], args[4], args[8], args[9]
    ghost = (gp < 0) | (gsize <= 0)
    assert torch.isneginf(got_s[ghost]).all() and (got_i[ghost] == -1).all()
    qmax, xmax = float((qg * qg).sum(-1).max().sqrt()), float(norms.max().sqrt())
    span = 4.0 * qmax * xmax + xmax * xmax if metric == "l2" else 2.0 * qmax * xmax
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4, level=span / levels)
    assert (got_i[~ghost][..., 0] >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 64])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("D", [32, 128])
def test_chunk_merge_tensor_core_body(dev, D, qt, kk, metric):
    """K7's tensor-core body at ct = 128 (one product a chunk): partitions
    that end inside a chunk, a chunk of one valid lane, a partition of one
    lane, an empty partition, ghost groups; kk up to 64 at qt = 64."""
    assert chunk_merge_body(qt, D, kk) == K7_MMA_BODY
    rng = np.random.default_rng(D * qt + kk)
    _k7_agree(_k7_case(dev, rng, 640, 128, qt, D, kk, metric))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("ct", [256, 512])
def test_chunk_merge_tensor_core_multi_segment_chunks(dev, ct, D, qt, metric):
    """K7's tensor-core body with chunks of two and four 128-row segments:
    each chunk's row range from a first pass, its keys from a second one."""
    assert chunk_merge_body(qt, D, 10) == K7_MMA_BODY
    rng = np.random.default_rng(ct + D + qt)
    _k7_agree(_k7_case(dev, rng, 1024, ct, qt, D, 10, metric))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
def test_chunk_merge_cuda_core_body_kept(dev, qt, metric):
    """D % 4 != 0: K7 keeps its CUDA-core body, same function."""
    assert chunk_merge_body(qt, 130, 10) == K7_GROUP_BODY
    rng = np.random.default_rng(qt)
    _k7_agree(_k7_case(dev, rng, 384, 128, qt, 130, 10, metric, Gn=16))


@pytest.mark.parametrize("qt,D,kk,body", [
    (64, 128, 10, K7_MMA_BODY), (64, 128, 64, K7_MMA_BODY), (64, 128, 100, K7_GROUP_BODY),
    (8, 768, 10, K7_MMA_BODY), (64, 130, 10, K7_GROUP_BODY), (32, 13, 10, K7_GROUP_BODY),
])
def test_chunk_merge_body_by_shape(dev, qt, D, kk, body):
    """K7's body by shape: the tensor cores where D % 4 == 0 and the ring,
    buffers and merge lists fit (a D past a stage streams in depth chunks)."""
    assert chunk_merge_body(qt, D, kk) == body


def _multi_agree(gp, qg, codes, ids, kk, metric, gb=1):
    C = codes.shape[1]
    got_s, got_i = multi_topk(gp, qg, codes, ids, kk, metric, gb=gb)
    want_s, want_i = multi_topk_plain(gp, qg, codes, ids, kk, metric)
    torch.cuda.synchronize()
    assert ((got_i >= 0) & (got_i <= C)).all()  # a slot of the partition, or the sentinel C
    assert ((got_i == C) == torch.isneginf(got_s)).all()
    got_i, want_i = got_i.masked_fill(got_i >= C, -1), want_i.masked_fill(want_i >= C, -1)
    _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    return got_s, got_i


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("D", [32, 128])
def test_multi_topk_skips_a_hole_of_no_ids(dev, D, qt, metric):
    """A slab whose middle 128-row segment holds no id (skipped, neither
    loaded nor multiplied) and valid rows again after it: the winners past
    the hole are found."""
    assert multi_topk_body(qt, D, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(D + qt)
    P, C, Gn = 4, 512, 16
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    ids[:, 128:256] = -1
    ids[1, 256:384] = -1  # two holes in a row
    ids[2] = -1  # a partition without any id
    codes[:, 128:256] = 50.0  # what a read of the hole would rank first
    gp = torch.tensor([0, 1, 2, 3] * 4, dtype=torch.int32, device=dev)
    gp[-1] = -1
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 300] * 3.0  # this row's best lies past the hole
    qg[1, 0] = codes[1, 400] * 3.0
    got_s, got_i = _multi_agree(gp, qg, codes, ids, 10, metric)
    assert int(got_i[0, 0, 0]) == 300 and int(got_i[1, 0, 0]) == 400
    assert not ((got_i >= 128) & (got_i < 256)).any()
    assert (got_i[2] == -1).all() and (got_i[-1] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
def test_multi_topk_segment_crosses_into_the_next_partition(dev, qt, metric):
    """C = 200: a partition's second segment reads 56 rows of the next one
    through the tensor map (the last partition's, past the end of the slabs);
    they are masked even where they would win."""
    assert multi_topk_body(qt, 32, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt)
    P, C, D, Gn = 4, 200, 32, 12
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes[1:, :56] = 20.0  # the rows a partition's second segment reads past its own
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    gp = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[:, :2] = 1.0  # rows that would rank the 20.0 rows first
    _multi_agree(gp, qg, codes, ids, 10, metric, gb=3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D", [(8, 32), (64, 128)])
def test_multi_topk_tensor_core_ties(dev, qt, D, metric):
    """Copies of one vector across segments score bit for bit alike on the
    tensor cores (|x|^2 summed in one order a row) and come out by the
    smaller slot."""
    assert multi_topk_body(qt, D, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + D)
    C, Gn = 512, 8
    codes, ids, gp, _ = _variant_store(dev, rng, C, 10, P=6, Gn=Gn, D=D)
    codes[0, 5::7] = codes[0, 5]
    gp[0] = 0
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 5] * 3.0  # the copies are this row's best
    got_s, got_i = _multi_agree(gp, qg, codes, ids, 10, metric)
    tied = torch.diff(got_s, dim=2) == 0
    assert bool(tied[0, 0].all())
    assert (torch.diff(got_i, dim=2)[tied & (got_i[:, :, 1:] >= 0)] > 0).all()


@pytest.mark.parametrize("qt,D,kk,body", [
    (64, 128, 10, MULTI_MMA_BODY), (64, 128, 82, MULTI_MMA_BODY),
    (64, 128, 83, MULTI_CUDA_CORE_BODY), (64, 128, 128, MULTI_CUDA_CORE_BODY),
    (8, 768, 10, MULTI_MMA_BODY), (64, 130, 10, MULTI_CUDA_CORE_BODY),
    (16, 13, 10, MULTI_CUDA_CORE_BODY),
])
def test_multi_topk_body_by_shape(dev, qt, D, kk, body):
    """multi_topk's body by shape: the tensor cores where D % 4 == 0 and the
    ring and the rows' lists fit (kk up to 82 at qt = 64, D = 128), else the
    CUDA-core body (kk = 128 there, as before)."""
    assert multi_topk_body(qt, D, kk) == body


@pytest.mark.parametrize("kk", [82, 83])
def test_multi_topk_largest_kk_on_the_tensor_cores_and_one_past(dev, kk):
    """qt = 64, D = 128: kk = 82, the largest whose lists fit beside the ring,
    runs the tensor-core body and kk = 83 the CUDA-core body; both agree with
    the plain version."""
    assert multi_topk_body(64, 128, kk) == (MULTI_MMA_BODY if kk == 82 else MULTI_CUDA_CORE_BODY)
    rng = np.random.default_rng(5)
    C, D, qt = 1024, 128, 64
    codes = torch.from_numpy(rng.standard_normal((2, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(2 * C).astype(np.int32).reshape(2, C)).to(dev)
    ids[1, 900:] = -1
    gp = torch.tensor([0, 1, -1, 1], dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((4, qt, D)).astype(np.float32)).to(dev)
    _multi_agree(gp, qg, codes, ids, kk, "l2", gb=2)


def test_chunk_merge_and_multi_topk_count_their_launches(dev):
    """One launch a call on either body; the plain versions count none."""
    rng = np.random.default_rng(3)
    args = _k7_case(dev, rng, 256, 128, 8, 32, 4, "l2", Gn=8)
    odd = _k7_case(dev, rng, 256, 128, 8, 13, 4, "l2", Gn=8)
    gp = torch.zeros(2, dtype=torch.int32, device=dev)
    ids = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    _ext.reset_launches()
    chunk_merge(*args)
    chunk_merge(*odd)
    chunk_merge_plain(*args)
    for D in (16, 13):
        qg, codes = torch.zeros((2, 8, D), device=dev), torch.zeros((1, 128, D), device=dev)
        multi_topk(gp, qg, codes, ids, 4, "ip", gb=2)
        multi_topk_plain(gp, qg, codes, ids, 4, "ip")
    torch.cuda.synchronize()
    assert _ext.launches["chunk_merge"] == 2 and _ext.launches["multi_topk"] == 2


# ------------------------------------------- K5 and K6 on the tensor cores

# (qt, D) of the tensor-core tests: D below a ring stage's depth (32), at it
# (128) and past it (768: depth chunks; at qt = 64 neither body of K5 or K6
# fits, see the body tests).
_TC_SHAPES = [(qt, D) for qt in (8, 16, 32, 64) for D in (32, 128, 768) if (qt, D) != (64, 768)]


def _largest_mma_kk(qt, D, C):
    """The largest kk <= C that K6's tensor-core body takes at (qt, D)."""
    kk = C
    while kk > 1 and exact_topk_body(qt, D, kk) != K6_MMA_BODY:
        kk -= 1
    return kk


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 100, 256])
@pytest.mark.parametrize("qt,D", _TC_SHAPES)
def test_rowscale_fold_tensor_core_tiles(dev, qt, D, kk, metric):
    """K5's tensor-core body: more groups than blocks, sizes around a segment
    (one segment: selected from the accumulator), partitions of several
    segments, an empty one, ghosts; kk up to 256, the most a fold keeps (two
    values a column). Against the f32 plain version and against the plain
    version on the split product."""
    assert rowscale_fold_body(qt, D, kk) == MMA_BODY
    rng = np.random.default_rng(qt + D + kk)
    C, Gn = 384, 200
    sizes_l = _tile_sizes(C) + [256, 300]
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(C)
    args = (gp, gsize, qg, codes, norms, kk, slot_mult, levels, metric, "fold")
    got, got_stats = rowscale_scan(*args)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    assert (got_stats[~alive][:, :, 0] == 0).all()
    assert (got_stats[~alive][:, :, 1] == np.float32(1e-20)).all()
    for model in (False, True):
        with bmm_as_split_product() if model else contextlib.nullcontext():
            want, want_stats = rowscale_scan_plain(*args)
        torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
        _packed_agree(got, want, alive, slot_mult, kk)


def _k6_case(dev, rng, mode, C, qt, D, Gn=60):
    """K6's inputs: partitions that fill the slab, end inside a segment, hold
    one lane, fewer than kk, none; ids -1 past each size (mode id); ghost
    groups (pid -1, and mode slot a live pid with size 0)."""
    P = 6
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor([C, C - 70, 0, 1, 5, 129], dtype=torch.int32, device=dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    lane = torch.arange(C, device=dev)[None, :]
    ids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:P] = torch.arange(P, dtype=torch.int32)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    kw = dict(group_size=gsize, norms=norms) if mode == "slot" else dict(ids=ids)
    return gp, qg, codes, kw


def _k6_agree(gp, qg, codes, kk, metric, mode, kw, models=(False, True)):
    """K6 against its plain version (f32, and on the split product's model):
    ghosts (-inf, -1), pairs rank by rank, equal scores by the larger index."""
    got_s, got_i = exact_scan(gp, qg, codes, kk, metric, mode, **kw)
    torch.cuda.synchronize()
    ghost = gp < 0
    if mode == "slot":
        ghost = ghost | (kw["group_size"] <= 0)
    assert torch.isneginf(got_s[ghost]).all() and (got_i[ghost] == -1).all()
    for model in models:
        with bmm_as_split_product() if model else contextlib.nullcontext():
            want_s, want_i = exact_scan_plain(gp, qg, codes, kk, metric, mode, **kw)
        _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    tied = torch.diff(got_s, dim=2) == 0
    assert (torch.diff(got_i, dim=2)[tied & (got_i[:, :, 1:] >= 0)] < 0).all()
    return got_s, got_i


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 100, "largest"])
@pytest.mark.parametrize("qt,D", _TC_SHAPES)
@pytest.mark.parametrize("mode", ["slot", "id"])
def test_exact_topk_tensor_core_tiles(dev, mode, qt, D, kk, metric):
    """K6's tensor-core body in both modes: more groups than blocks, odd C
    (200 at D = 32 and 768, 384 at D = 128), sizes below kk and inside a
    segment, an empty partition, ghosts; kk 1, 10 (one list entry a lane),
    100 and the largest its lists hold (merged, not inserted). kk = 100 at
    qt = 64 takes the CUDA-core body; it is held all the same."""
    C = 384 if D == 128 else 200
    kk = _largest_mma_kk(qt, D, C) if kk == "largest" else kk
    if kk in (1, 10) or qt < 64:
        assert exact_topk_body(qt, D, kk) == K6_MMA_BODY
    rng = np.random.default_rng(qt + D + kk + len(mode))
    gp, qg, codes, kw = _k6_case(dev, rng, mode, C, qt, D)
    _k6_agree(gp, qg, codes, kk, metric, mode, kw)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("D", [32, 128])
def test_exact_topk_id_skips_a_hole_of_no_ids(dev, D, qt, metric):
    """Mode id: a slab whose middle 128-row segment holds no id (skipped,
    neither loaded nor multiplied), two such segments in a row, a partition
    without any id; the winners past the hole are found, none from it."""
    assert exact_topk_body(qt, D, 10) == K6_MMA_BODY
    rng = np.random.default_rng(D + qt + 1)
    P, C, Gn = 4, 512, 16
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    ids[:, 128:256] = -1
    ids[1, 256:384] = -1
    ids[2] = -1
    codes[:, 128:256] = 50.0  # what a read of the hole would rank first
    gp = torch.tensor([0, 1, 2, 3] * 4, dtype=torch.int32, device=dev)
    gp[-1] = -1
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 300] * 3.0  # this row's best lies past the hole
    qg[1, 0] = codes[1, 400] * 3.0
    got_s, got_i = _k6_agree(gp, qg, codes, 10, metric, "id", dict(ids=ids))
    assert int(got_i[0, 0, 0]) == int(ids[0, 300]) and int(got_i[1, 0, 0]) == int(ids[1, 400])
    assert set(got_i.flatten().tolist()) <= set(ids.flatten().tolist())  # none from a hole
    assert (got_i[2] == -1).all() and (got_i[-1] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("mode", ["slot", "id"])
def test_exact_topk_segment_crosses_into_the_next_partition(dev, mode, qt, metric):
    """C = 200: a partition's second segment reads 56 rows of the next one
    through the tensor map (the last partition's, past the end of the slabs);
    they are masked even where they would win."""
    assert exact_topk_body(qt, 32, 10) == K6_MMA_BODY
    rng = np.random.default_rng(qt + len(mode))
    P, C, D, Gn = 4, 200, 32, 12
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes[1:, :56] = 20.0  # the rows a partition's second segment reads past its own
    norms = (codes * codes).sum(-1).contiguous()
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    gp = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32, device=dev)
    gsize = torch.full((Gn,), C, dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[:, :2] = 1.0  # rows that would rank the 20.0 rows first
    kw = dict(group_size=gsize, norms=norms) if mode == "slot" else dict(ids=ids)
    _k6_agree(gp, qg, codes, 10, metric, mode, kw)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D", [(8, 32), (64, 128)])
@pytest.mark.parametrize("mode", ["slot", "id"])
def test_exact_topk_tensor_core_ties(dev, mode, qt, D, metric):
    """Copies of one vector across segments score bit for bit alike on the
    tensor cores (mode id: |x|^2 summed in one order a row; mode slot: the
    store's norms) and come out by the larger index, the row's kk best all
    copies."""
    assert exact_topk_body(qt, D, 10) == K6_MMA_BODY
    rng = np.random.default_rng(qt + D + 7)
    C, Gn = 512, 8
    gp, qg, codes, kw = _k6_case(dev, rng, mode, C, qt, D, Gn=Gn)
    codes[0, 5::7] = codes[0, 5]
    if mode == "slot":
        kw["norms"] = (codes * codes).sum(-1).contiguous()
    qg[0, 0] = codes[0, 5] * 3.0  # the copies are this row's best
    got_s, _ = _k6_agree(gp, qg, codes, 10, metric, mode, kw)
    assert bool((torch.diff(got_s[0, 0]) == 0).all())


@pytest.mark.parametrize("qt,D,kk,k5,k6", [
    (64, 128, 10, MMA_BODY, K6_MMA_BODY), (64, 128, 82, MMA_BODY, K6_MMA_BODY),
    (64, 128, 83, MMA_BODY, K6_GROUP_BODY), (32, 768, 10, MMA_BODY, K6_MMA_BODY),
    (64, 768, 10, GROUP_BODY, K6_GROUP_BODY), (64, 130, 10, GROUP_BODY, K6_GROUP_BODY),
    (8, 770, 10, GROUP_BODY, K6_GROUP_BODY), (16, 13, 10, GROUP_BODY, K6_GROUP_BODY),
])
def test_rowscale_fold_and_exact_topk_body_by_shape(dev, qt, D, kk, k5, k6):
    """K5's and K6's bodies by shape: the tensor cores where D % 4 == 0 and
    the ring, query tile and (K6) the rows' lists fit; K5 keeps no list, so kk
    does not move it."""
    assert rowscale_fold_body(qt, D, kk) == k5
    assert exact_topk_body(qt, D, kk) == k6


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
def test_rowscale_fold_and_exact_topk_cuda_core_bodies_kept(dev, qt, metric):
    """D = 130: K5 and K6 keep their CUDA-core bodies, same function; D = 770
    at qt = 8 fits neither K5's nor K6's and raises."""
    rng = np.random.default_rng(qt + 130)
    C, D, Gn = 384, 130, 16
    codes = torch.from_numpy(rng.standard_normal((6, C, D)).astype(np.float32)).to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.tensor([C, 300, 0, 1, 5, 129], dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, 6, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(C)
    args = (gp, gsize, qg, codes, norms, 10, slot_mult, levels, metric, "fold")
    got, got_stats = rowscale_scan(*args)
    want, want_stats = rowscale_scan_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    _packed_agree(got, want, gsize > 0, slot_mult, 10)
    for mode in ("slot", "id"):
        gp6, qg6, codes6, kw = _k6_case(dev, rng, mode, 200, qt, D, Gn=Gn)
        _k6_agree(gp6, qg6, codes6, 10, metric, mode, kw, models=(False,))
    wide = torch.zeros((2, 256, 770), device=dev)
    gp2 = torch.zeros(2, dtype=torch.int32, device=dev)
    qg2, n2 = torch.zeros((2, 8, 770), device=dev), torch.zeros((2, 256), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        rowscale_scan(gp2, gp2 + 256, qg2, wide, n2, 10, slot_mult, levels, "l2", "fold")
    with pytest.raises(ValueError, match="shared memory"):
        exact_scan(gp2, qg2, wide, 10, "l2", "slot", group_size=gp2 + 256, norms=n2)


def test_rowscale_fold_and_exact_topk_count_their_launches(dev):
    """One launch a call on either body of K5 and of K6 (both modes); the
    plain versions count none."""
    rng = np.random.default_rng(4)
    _ext.reset_launches()
    for D in (32, 13):
        codes = torch.from_numpy(rng.standard_normal((2, 256, D)).astype(np.float32)).to(dev)
        norms = (codes * codes).sum(-1).contiguous()
        ids = torch.arange(512, dtype=torch.int32, device=dev).reshape(2, 256)
        gp = torch.tensor([0, 1], dtype=torch.int32, device=dev)
        gsize = torch.tensor([256, 100], dtype=torch.int32, device=dev)
        qg = torch.from_numpy(rng.standard_normal((2, 8, D)).astype(np.float32)).to(dev)
        args = (gp, gsize, qg, codes, norms, 4, *packed_params(256), "l2", "fold")
        rowscale_scan(*args)
        rowscale_scan_plain(*args)
        for mode, kw in (("slot", dict(group_size=gsize, norms=norms)), ("id", dict(ids=ids))):
            exact_scan(gp, qg, codes, 4, "ip", mode, **kw)
            exact_scan_plain(gp, qg, codes, 4, "ip", mode, **kw)
    torch.cuda.synchronize()
    assert _ext.launches["rowscale_fold"] == 2 and _ext.launches["exact_topk"] == 4


# ------------------------------------------- K8 and K9 on the tensor cores


def _largest_k9_mma_kk(qt, D, C):
    """The largest kk <= C that K9's tensor-core body takes at (qt, D)."""
    kk = C
    while kk > 1 and packed_topk_body(qt, D, kk) != MULTI_MMA_BODY:
        kk -= 1
    return kk


def _k8_k9_case(dev, rng, C, qt, D, Gn=120):
    """Partitions of 0, 1, 127, 128, 129, C, 256 and 300 rows (ids -1 past
    each size: segments without an id), a C that no segment divides, ghost
    groups, more groups than blocks."""
    sizes_l = _tile_sizes(C) + [256, 300]
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    lane = torch.arange(C, device=dev)[None, :]
    sizes = torch.tensor(sizes_l, device=dev)
    ids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:P] = torch.arange(P, dtype=torch.int32)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    return gp, qg, codes, ids


def _k8_agree(got, want):
    """K8 against a plain version: the same -inf lanes, scores within
    rtol = atol = 1e-4."""
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    ok = ~torch.isneginf(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 40, "largest"])
@pytest.mark.parametrize("D", [24, 100, 128, 200, 256])
@pytest.mark.parametrize("qt", [8, 16, 32, 64])
def test_raw_scores_and_packed_topk_tensor_core_tiles(dev, qt, D, kk, metric):
    """K8 and K9 on the tensor cores: sizes around a segment, segments
    without an id, a C that no segment divides (520: the last segment reads
    the next partition's rows), ghost groups, D in one ring stage (24, 100,
    128) and in depth chunks (200, 256); kk 1, 10, 40 and the largest the
    tensor-core body's lists hold. Both against the f32 plain versions and
    the plain versions on the split product's model; K9 equal to the top kk
    of K8's scores, packed (one body, one arithmetic)."""
    C = 520
    kk = _largest_k9_mma_kk(qt, D, C) if kk == "largest" else kk
    assert raw_scores_body(qt, D) == MULTI_MMA_BODY
    assert packed_topk_body(qt, D, kk) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + D + kk)
    gp, qg, codes, ids = _k8_k9_case(dev, rng, C, qt, D)
    raw = raw_scores(gp, qg, codes, ids, metric)
    got = packed_topk(gp, qg, codes, ids, kk, metric)
    torch.cuda.synchronize()
    assert torch.isneginf(raw[gp < 0]).all() and (got[gp < 0] == -1).all()
    assert torch.isneginf(raw[:, :, 128:256][gp == 1]).all()  # a segment without an id
    for model in (False, True):
        with bmm_as_split_product() if model else contextlib.nullcontext():
            want_raw = raw_scores_plain(gp, qg, codes, ids, metric)
            want = packed_topk_plain(gp, qg, codes, ids, kk, metric)
        _k8_agree(raw, want_raw)
        _k9_agree(got, want, raw, slot_bits_of(C), exact=not model)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
@pytest.mark.parametrize("D", [32, 128])
def test_raw_scores_and_packed_topk_skip_a_hole_of_no_ids(dev, D, qt, metric):
    """A slab whose middle 128-row segment holds no id (neither loaded nor
    multiplied: K8 writes -inf there, K9 takes nothing from it), two such
    segments in a row, a partition without any id; K9's winners past the hole
    are found."""
    assert raw_scores_body(qt, D) == packed_topk_body(qt, D, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(D + qt + 2)
    P, C, Gn = 4, 512, 16
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    ids[:, 128:256] = -1
    ids[1, 256:384] = -1
    ids[2] = -1
    codes[:, 128:256] = 50.0  # what a read of the hole would rank first
    gp = torch.tensor([0, 1, 2, 3] * 4, dtype=torch.int32, device=dev)
    gp[-1] = -1
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[0, 0] = codes[0, 300] * 3.0  # this row's best lies past the hole
    qg[1, 0] = codes[1, 400] * 3.0
    raw = raw_scores(gp, qg, codes, ids, metric)
    got = packed_topk(gp, qg, codes, ids, 10, metric)
    torch.cuda.synchronize()
    _k8_agree(raw, raw_scores_plain(gp, qg, codes, ids, metric))
    _k9_agree(got, packed_topk_plain(gp, qg, codes, ids, 10, metric), raw, slot_bits_of(C))
    assert torch.isneginf(raw[:, :, 128:256]).all() and torch.isneginf(raw[gp == 2]).all()
    lanes = got & ((1 << slot_bits_of(C)) - 1)
    assert int(lanes[0, 0, 0]) == 300 and int(lanes[1, 0, 0]) == 400
    assert not ((lanes >= 128) & (lanes < 256) & (got >= 0)).any()
    assert (got[2] == -1).all() and (got[-1] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
def test_raw_scores_and_packed_topk_segment_crosses_into_the_next_partition(dev, qt, metric):
    """C = 200: a partition's second segment reads 56 rows of the next one
    through the tensor map (the last partition's, past the end of the slabs);
    K8 writes no lane at or past C and K9 takes none, even where they would
    win."""
    assert raw_scores_body(qt, 32) == packed_topk_body(qt, 32, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + 3)
    P, C, D, Gn = 4, 200, 32, 12
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes[1:, :56] = 20.0  # the rows a partition's second segment reads past its own
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    gp = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[:, :2] = 1.0  # rows that would rank the 20.0 rows first
    raw = raw_scores(gp, qg, codes, ids, metric)
    got = packed_topk(gp, qg, codes, ids, 10, metric)
    torch.cuda.synchronize()
    _k8_agree(raw, raw_scores_plain(gp, qg, codes, ids, metric))
    _k9_agree(got, packed_topk_plain(gp, qg, codes, ids, 10, metric), raw, slot_bits_of(C))
    assert ((got & 255) < C)[got >= 0].all()


@pytest.mark.parametrize("C", [126, 130, 200])
@pytest.mark.parametrize("qt", [8, 64])
def test_raw_scores_tensor_core_rows_not_16_byte_aligned(dev, qt, C):
    """C % 4 != 0 (126, 130) puts output rows off 16-byte boundaries: K8's
    tensor-core body stores them a value at a time, none at or past a row's
    C lanes (they would land on the next row's), and agrees with the plain
    version; C = 200 takes the 16-byte stores."""
    assert raw_scores_body(qt, 32) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + C)
    P, D, Gn = 3, 32, 10
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
    ids[1, C // 2:] = -1
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:P] = torch.arange(P, dtype=torch.int32)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    raw = raw_scores(gp, qg, codes, ids, "l2")
    torch.cuda.synchronize()
    _k8_agree(raw, raw_scores_plain(gp, qg, codes, ids, "l2"))
    assert torch.isneginf(raw[gp == 1][:, :, C // 2:]).all()


@pytest.mark.parametrize("qt,D,kk,k8,k9", [
    (64, 128, 10, MULTI_MMA_BODY, MULTI_MMA_BODY), (64, 128, 82, MULTI_MMA_BODY, MULTI_MMA_BODY),
    (64, 128, 83, MULTI_MMA_BODY, MULTI_CUDA_CORE_BODY),
    (64, 32, 98, MULTI_MMA_BODY, MULTI_MMA_BODY),
    (64, 32, 99, MULTI_MMA_BODY, MULTI_CUDA_CORE_BODY),
    (64, 128, 384, MULTI_MMA_BODY, MULTI_CUDA_CORE_BODY),
    (32, 768, 10, MULTI_MMA_BODY, MULTI_MMA_BODY), (64, 768, 10, MULTI_CUDA_CORE_BODY,
                                                    MULTI_CUDA_CORE_BODY),
    (8, 768, 10, MULTI_MMA_BODY, MULTI_MMA_BODY), (64, 130, 10, MULTI_CUDA_CORE_BODY,
                                                   MULTI_CUDA_CORE_BODY),
    (16, 13, 10, MULTI_CUDA_CORE_BODY, MULTI_CUDA_CORE_BODY),
])
def test_raw_scores_and_packed_topk_body_by_shape(dev, qt, D, kk, k8, k9):
    """K8's and K9's bodies by shape: the tensor cores where D % 4 == 0 and
    the ring, the query tile and (K9) the rows' lists fit; K8 keeps no list,
    so kk does not move it (it takes the tensor cores at every D % 4 == 0
    whose query tile fits, K9 up to kk = 82 at qt = 64, D = 128 and 98 at
    D = 32)."""
    assert raw_scores_body(qt, D) == k8
    assert packed_topk_body(qt, D, kk) == k9


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D,kk", [(64, 128, 83), (64, 128, 200), (64, 32, 99), (64, 24, 100),
                                     (64, 200, 100), (16, 13, 10), (64, 130, 10)])
def test_packed_topk_cuda_core_body_equals_k8_on_a_padded_depth(dev, qt, D, kk, metric):
    """Where K9 keeps its CUDA-core body, its output is the top kk of K8's
    scores, packed, with K8 run on the same inputs and the depth padded by a
    zero column (D % 4 != 0: K8's CUDA-core body, whose sums gain zero terms
    only); where D % 4 != 0 already, K8 at the same D."""
    assert packed_topk_body(qt, D, kk) == MULTI_CUDA_CORE_BODY
    rng = np.random.default_rng(qt + D + kk + 5)
    C = 384
    gp, qg, codes, ids = _k8_k9_case(dev, rng, C, qt, D, Gn=24)
    got = packed_topk(gp, qg, codes, ids, kk, metric)
    raw, body = _k8_as_k9(gp, qg, codes, ids, kk, metric)
    torch.cuda.synchronize()
    assert body == MULTI_CUDA_CORE_BODY
    _k9_agree(got, packed_topk_plain(gp, qg, codes, ids, kk, metric), raw, slot_bits_of(C))


@pytest.mark.parametrize("D,pad", [(13, 1), (13, 2), (127, 2), (130, 1)])
def test_raw_scores_zero_columns_leave_the_cuda_core_sums_unchanged(dev, D, pad):
    """What the padded exact check rests on: K8's CUDA-core body gives the
    same scores, bit for bit, when the depth is padded by zero columns (the
    sums gain fmaf(0, 0, a) = a terms only)."""
    assert raw_scores_body(64, D) == raw_scores_body(64, D + pad) == MULTI_CUDA_CORE_BODY
    rng = np.random.default_rng(D + pad)
    gp, qg, codes, ids = _k8_k9_case(dev, rng, 200, 64, D, Gn=24)
    padded = [torch.nn.functional.pad(t, (0, pad)).contiguous() for t in (qg, codes)]
    for metric in ("l2", "ip"):
        a = raw_scores(gp, qg, codes, ids, metric)
        b = raw_scores(gp, padded[0], padded[1], ids, metric)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_raw_scores_and_packed_topk_need_16_byte_aligned_operands(dev):
    """The tensor-core bodies' copies need qg and codes on 16-byte
    boundaries: a tile that starts 4 bytes in raises."""
    Gn, qt, D, C = 2, 8, 32, 128
    buf = torch.zeros(Gn * qt * D + 1, device=dev)
    qg = buf[1:].view(Gn, qt, D)
    codes = torch.zeros((1, C, D), device=dev)
    ids = torch.zeros((1, C), dtype=torch.int32, device=dev)
    gp = torch.zeros(Gn, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte boundary"):
        raw_scores(gp, qg, codes, ids, "l2")
    with pytest.raises(ValueError, match="16-byte boundary"):
        packed_topk(gp, qg, codes, ids, 4, "l2")


def test_raw_scores_and_packed_topk_count_their_launches(dev):
    """One launch a call on either body of K8 and of K9; the plain versions
    count none."""
    gp = torch.zeros(2, dtype=torch.int32, device=dev)
    ids = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    _ext.reset_launches()
    for D in (16, 13):
        assert raw_scores_body(8, D) == packed_topk_body(8, D, 4) == (
            MULTI_MMA_BODY if D == 16 else MULTI_CUDA_CORE_BODY)
        qg, codes = torch.zeros((2, 8, D), device=dev), torch.zeros((1, 128, D), device=dev)
        raw_scores(gp, qg, codes, ids, "ip")
        raw_scores_plain(gp, qg, codes, ids, "ip")
        packed_topk(gp, qg, codes, ids, 4, "ip")
        packed_topk_plain(gp, qg, codes, ids, 4, "ip")
    torch.cuda.synchronize()
    assert _ext.launches["raw_scores"] == 2 and _ext.launches["packed_topk"] == 2


# ------------------------------------------- sized_topk on the tensor cores


def _largest_sized_mma_kk(qt, D, C):
    """The largest kk <= C that sized_topk's tensor-core body takes at (qt, D)."""
    kk = C
    while kk > 1 and sized_topk_body(qt, D, kk) != MULTI_MMA_BODY:
        kk -= 1
    return kk


_POISONS = (999.0, float("inf"), float("nan"))


def _sized_case(dev, rng, C, qt, D, Gn=60):
    """Partitions of 0, 1, 127, 128, 129, 256, 300 and C rows, every row
    past a size poisoned with 999, +inf or NaN (the segment that holds the
    size-th row is loaded whole); the last partition full, so that its last
    segment reaches past the end of the tensor map where C % 128 != 0; copies
    of one vector in the full partition; ghost groups (pid -1, and a live pid
    of size 0); more groups than blocks."""
    sizes_l = [0, 1, 127, 128, 129, 256, 300, C]
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes[P - 1, 3::7] = codes[P - 1, 3]
    for p, size in enumerate(sizes_l):
        codes[p, size:] = _POISONS[p % 3]
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gp[:P] = torch.arange(P, dtype=torch.int32)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[P - 1, 0] = codes[P - 1, 3] * 3.0  # the copies are this row's best
    return gp, gsize, qg, codes


def _sized_agree(gp, gsize, qg, codes, kk, metric, models=(False, True)):
    """sized_topk against its plain version (f32, and on the split product's
    model): ghosts (-inf, -1), finite scores at slots below the size alone,
    pairs rank by rank, equal scores by the larger slot."""
    got_s, got_i = sized_topk(gp, gsize, qg, codes, kk, metric)
    torch.cuda.synchronize()
    ghost = (gp < 0) | (gsize <= 0)
    assert torch.isneginf(got_s[ghost]).all() and (got_i[ghost] == -1).all()
    assert torch.isfinite(got_s[got_i >= 0]).all()
    assert (got_i < gsize[:, None, None]).all()
    for model in models:
        with bmm_as_split_product() if model else contextlib.nullcontext():
            want_s, want_i = sized_topk_plain(gp, gsize, qg, codes, kk, metric)
        _pairs_match(got_s, got_i, want_s, want_i, 1e-4)
    tied = torch.diff(got_s, dim=2) == 0
    assert (torch.diff(got_i, dim=2)[tied & (got_i[:, :, 1:] >= 0)] < 0).all()
    return got_s, got_i


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [1, 10, 40, "largest"])
@pytest.mark.parametrize("D", [24, 100, 128, 256])
@pytest.mark.parametrize("qt", [8, 16, 32, 64])
def test_sized_topk_tensor_core_tiles(dev, qt, D, kk, metric):
    """sized_topk's tensor-core body (mode kSized): sizes 0, 1, 127, 128, 129
    and C (520: no segment divides it) with poisoned rows past them, D in one
    ring stage (24, 100, 128) and in depth chunks (256), kk 1, 10, 40 and the
    largest its lists hold; against the f32 plain version and the plain
    version on the split product's model, ties by the larger slot."""
    C = 520
    kk = _largest_sized_mma_kk(qt, D, C) if kk == "largest" else kk
    assert sized_topk_body(qt, D, kk) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + D + kk + 9)
    got_s, _ = _sized_agree(*_sized_case(dev, rng, C, qt, D), kk, metric)
    if kk > 1:
        assert bool((torch.diff(got_s[7, 0, :min(kk, 74)]) == 0).all())  # the copies tie


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt", [8, 64])
def test_sized_topk_segment_reaches_the_end_of_the_tensor_map(dev, qt, metric):
    """C = 200: the last partition's second segment reads 56 rows past the
    end of the slabs (the tensor map fills them with zeros) and every other
    partition's reads the next one's rows; none of them is at a lane below
    the size."""
    assert sized_topk_body(qt, 32, 10) == MULTI_MMA_BODY
    rng = np.random.default_rng(qt + 4)
    P, C, D, Gn = 4, 200, 32, 12
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes[1:, :56] = 20.0  # what a read past a partition's own rows would rank first
    gp = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32, device=dev)
    gsize = torch.tensor([C, 150, C, C] * 3, dtype=torch.int32, device=dev)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev)
    qg[:, :2] = 1.0
    _sized_agree(gp, gsize, qg, codes, 10, metric)


@pytest.mark.parametrize("qt,D,kk,body", [
    (64, 128, 10, MULTI_MMA_BODY), (64, 128, 82, MULTI_MMA_BODY),
    (64, 128, 83, MULTI_CUDA_CORE_BODY), (64, 128, 128, MULTI_CUDA_CORE_BODY),
    (64, 32, 98, MULTI_MMA_BODY), (64, 32, 99, MULTI_CUDA_CORE_BODY),
    (32, 768, 10, MULTI_MMA_BODY), (64, 768, 10, MULTI_CUDA_CORE_BODY),
    (64, 130, 10, MULTI_CUDA_CORE_BODY), (16, 13, 10, MULTI_CUDA_CORE_BODY),
])
def test_sized_topk_body_by_shape(dev, qt, D, kk, body):
    """sized_topk's body by shape, that of multi_topk and K9 (one pair_body):
    the tensor cores where D % 4 == 0 and the ring, the query tile and the
    rows' lists fit."""
    assert sized_topk_body(qt, D, kk) == body
    assert sized_topk_body(qt, D, kk) == multi_topk_body(qt, D, kk) == packed_topk_body(qt, D, kk)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D,kk", [(64, 128, 83), (64, 128, 128), (16, 13, 10), (64, 130, 10)])
def test_sized_topk_cuda_core_body_kept(dev, qt, D, kk, metric):
    """Where the tensor-core body does not serve the shape, the CUDA-core
    body runs it, the same function (kk = 128 at qt = 64, D = 128 is the
    largest it holds)."""
    assert sized_topk_body(qt, D, kk) == MULTI_CUDA_CORE_BODY
    rng = np.random.default_rng(qt + D + kk)
    _sized_agree(*_sized_case(dev, rng, 520, qt, D, Gn=24), kk, metric, models=(False,))


def test_sized_topk_needs_16_byte_aligned_operands(dev):
    """The tensor-core body's copies need qg and codes on 16-byte
    boundaries: a tile that starts 4 bytes in raises."""
    Gn, qt, D, C = 2, 8, 32, 128
    assert sized_topk_body(qt, D, 4) == MULTI_MMA_BODY
    buf = torch.zeros(Gn * qt * D + 1, device=dev)
    gp = torch.zeros(Gn, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sized_topk(gp, gp + C, buf[1:].view(Gn, qt, D), torch.zeros((1, C, D), device=dev), 4,
                   "l2")


def test_sized_topk_counts_its_launches(dev):
    """One launch a call on either body; the plain version counts none."""
    gp = torch.zeros(2, dtype=torch.int32, device=dev)
    _ext.reset_launches()
    for D in (16, 13):
        qg, codes = torch.zeros((2, 8, D), device=dev), torch.zeros((1, 128, D), device=dev)
        sized_topk(gp, gp + 100, qg, codes, 4, "l2")
        sized_topk_plain(gp, gp + 100, qg, codes, 4, "l2")
    torch.cuda.synchronize()
    assert _ext.launches["sized_topk"] == 2


def test_kernels_on_a_store_after_removal_and_growth(dev):
    """Contract 7 (ROADMAP Queue 3): after removals (_remove_compact) and a
    flood that grows C (_grow_capacity: new tensors), K1 (through v8, with
    K2), sized_topk and multi_topk encode their tensor maps over the new
    tensors and agree with the same scans on a CPU copy of the store (their
    plain versions)."""
    rng = np.random.default_rng(21)
    n, D, nlist = 6000, 32, 8
    x = rng.standard_normal((n, D)).astype(np.float32)
    store = PartitionStore(D, dev)
    store.init_from_assignments(x, np.arange(n), rng.standard_normal((nlist, D)),
                                rng.integers(0, nlist, n))
    store.remove(rng.choice(n, n // 3, replace=False))
    C0 = store.C
    flood = C0 + 50
    store.append(np.full(flood, 3, np.int32),
                 (x[:flood] + 0.01 * rng.standard_normal((flood, D))).astype(np.float32),
                 np.arange(10_000, 10_000 + flood))
    st = store.state
    assert store.C == 2 * C0 and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                                     for t in (st.codes, st.ids, st.norms))
    q = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32)).to(dev)
    pids = torch.from_numpy(np.stack([rng.permutation(nlist)[:3] for _ in range(64)])
                            .astype(np.int32)).to(dev)
    pids[:, 0] = 3  # every query probes the grown partition
    cpu = [t.cpu() for t in (st.codes, st.ids, st.sizes, st.norms, q, pids)]
    scans = {"grouped_scan": lambda c, i, s, nr, qq, pp: grouped_scan_v8(c, i, s, nr, qq, pp, 10,
                                                                         "l2", gpb=4),
             "sized_topk": lambda c, i, s, nr, qq, pp: grouped_scan_sized(c, i, s, qq, pp, 10,
                                                                          "l2", qt=16),
             "multi_topk": lambda c, i, s, nr, qq, pp: grouped_scan_multi(c, i, qq, pp, 10, "l2",
                                                                          qt=16, gb=4)}
    for kernel, scan in scans.items():
        _ext.reset_launches()
        got_s, got_i, _ = scan(st.codes, st.ids, st.sizes, st.norms, q, pids)
        torch.cuda.synchronize()
        assert _ext.launches[kernel] == 1
        want_s, want_i, _ = scan(*cpu)
        assert _overlap(got_i.cpu(), want_i) >= 0.99
        torch.testing.assert_close(got_s.cpu(), want_s, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- K1 on bf16 codes


def _bf16_k1_inputs(rng, dev, qt, D, C=512, Gn=300):
    """K1's inputs on a bf16 store: partitions of the segment-stressing
    sizes (ghosts, a partial last segment), queries scaled to the key range
    and rounded to bf16, normsT from the rounded codes' f32 norms."""
    sizes_l = _tile_sizes(C)
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dev)
    codes = codes.to(torch.bfloat16)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    slot_mult, levels = packed_params(C)
    scale = levels / (10.0 * D ** 0.5)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32) * scale).to(dev)
    cf = codes.float()
    normsT = (((cf * cf).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
    return gp, gsize, qg.to(torch.bfloat16).contiguous(), codes, normsT, slot_mult, levels


@pytest.mark.parametrize("kk", [10, 100])
@pytest.mark.parametrize("D", [128, 96, 100, 768])
@pytest.mark.parametrize("qt", [8, 16, 32, 64])
def test_grouped_scan_bf16_matches_plain(dev, qt, D, kk):
    """K1 on bf16 operands against its plain version: the tensor-core body
    at D % 8 == 0 (D = 768 streams through the ring in depth chunks), the
    CUDA-core body at D = 100; 300 groups, ghosts, sizes around a segment.
    One launch a call, counted under grouped_scan_bf16."""
    assert grouped_scan_uses_mma(qt, D, torch.bfloat16) == (D % 8 == 0)
    rng = np.random.default_rng(qt + D + kk)
    gp, gsize, qg, codes, normsT, slot_mult, levels = _bf16_k1_inputs(rng, dev, qt, D)
    args = (gp, gsize, qg, codes, normsT, kk, slot_mult, levels)
    _ext.reset_launches()
    got = grouped_scan_kernel(*args)
    torch.cuda.synchronize()
    assert _ext.launches["grouped_scan_bf16"] == 1 and _ext.launches["grouped_scan"] == 0
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    assert (got[alive] >= -1).all() and torch.isfinite(got).all()
    _packed_agree(got, grouped_scan_plain(*args), alive, slot_mult, kk)


def test_grouped_scan_bf16_checks_its_operands(dev):
    """bf16 codes need bf16 query tiles (and f32 ones f32): a mismatch is
    refused before any launch."""
    rng = np.random.default_rng(5)
    gp, gsize, qg, codes, normsT, slot_mult, levels = _bf16_k1_inputs(rng, dev, 8, 128, Gn=4)
    with pytest.raises(ValueError, match="qg"):
        grouped_scan_kernel(gp, gsize, qg.float(), codes, normsT, 10, slot_mult, levels)


def test_kernels_on_a_bf16_store_after_removal_and_growth(dev):
    """Contract 7 on a bf16 store: after removals and a flood that grows C
    (new tensors), K1's bf16 body (through v8 with K2, and v11) encodes its
    bf16 tensor map over the new codes and agrees with the same scans on a
    CPU copy of the store (the plain versions)."""
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_v11

    rng = np.random.default_rng(22)
    n, D, nlist = 6000, 64, 8
    x = rng.standard_normal((n, D)).astype(np.float32)
    store = PartitionStore(D, dev, dtype=torch.bfloat16)
    store.init_from_assignments(x, np.arange(n), rng.standard_normal((nlist, D)),
                                rng.integers(0, nlist, n))
    store.remove(rng.choice(n, n // 3, replace=False))
    C0 = store.C
    flood = C0 + 50
    store.append(np.full(flood, 3, np.int32),
                 (x[:flood] + 0.01 * rng.standard_normal((flood, D))).astype(np.float32),
                 np.arange(10_000, 10_000 + flood))
    st = store.state
    assert store.C == 2 * C0 and st.codes.dtype == torch.bfloat16
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (st.codes, st.ids, st.norms))
    q = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32)).to(dev)
    pids = torch.from_numpy(np.stack([rng.permutation(nlist)[:3] for _ in range(64)])
                            .astype(np.int32)).to(dev)
    pids[:, 0] = 3  # every query probes the grown partition
    cpu = [t.cpu() for t in (st.codes, st.ids, st.sizes, st.norms, q, pids)]
    for scan in (lambda *a: grouped_scan_v8(*a, 10, "l2", gpb=4),
                 lambda *a: grouped_scan_v11(*a, 10, "l2", qt=16, gpb=4),
                 lambda *a: grouped_scan_v11(*a, 10, "l2", qt=16, gpb=4, exact=False)):
        _ext.reset_launches()
        got_s, got_i, _ = scan(st.codes, st.ids, st.sizes, st.norms, q, pids)
        torch.cuda.synchronize()
        assert _ext.launches["grouped_scan_bf16"] == 1 and _ext.launches["merge_positions"] == 1
        want_s, want_i, _ = scan(*cpu)
        assert _overlap(got_i.cpu(), want_i) >= 0.99
        same = got_i.cpu() == want_i
        torch.testing.assert_close(got_s.cpu()[same], want_s[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("exact", [True, False])
def test_bf16_index_on_the_card_matches_its_cpu_load(dev, tmp_path, monkeypatch, exact):
    """A bf16 QuakeIndex built on the card, saved and loaded on the CPU: the
    default search (K1's bf16 body, K2, K3 on the f32 parent) against the
    plain versions on the loaded copy, exact and dequantized."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    rng = np.random.default_rng(23)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    q = rng.standard_normal((256, 64)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=32, precision="bf16", calibrate_aps=False))
    idx.save(str(tmp_path / "b"))
    cpu = QuakeIndex(device="cpu").load(str(tmp_path / "b"))
    assert torch.equal(cpu.store.state.codes.view(torch.int16),
                       idx.store.state.codes.view(torch.int16).cpu())
    sp = SearchParams(k=10, nprobe=4, exact_distances=exact)
    _ext.reset_launches()
    got = idx.search(q, sp)
    assert _ext.launches["grouped_scan_bf16"] == 1 and _ext.launches["flat_topk"] == 1
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")  # K3's plain version on the CPU
    want = cpu.search(q, sp)
    assert _overlap(torch.from_numpy(got.ids), torch.from_numpy(want.ids)) >= 0.99


# ------------------------- the bf16 bodies of K3-K9, sized_topk and multi_topk


def _bf16_scan_store(dev, rng, C, D):
    """Eight bf16 partitions of C rows (sizes 0, 1, 127, 128, 129, all, 256,
    300; ids past each size -1), their f32 norms, sizes and ids."""
    sizes_l = [0, 1, 127, 128, 129, C, min(256, C), min(300, C)]
    codes = torch.from_numpy(rng.standard_normal((8, C, D)).astype(np.float32)).to(dev)
    codes = codes.to(torch.bfloat16)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    lane = torch.arange(C, device=dev)[None, :]
    ids = torch.where(lane < sizes[:, None],
                      torch.arange(8 * C, dtype=torch.int32, device=dev).reshape(8, C), -1)
    norms = (codes.float() ** 2).sum(-1).contiguous()
    return codes, norms, sizes, ids.to(torch.int32).contiguous()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qt,D", [(8, 128), (64, 128), (32, 768), (16, 100), (64, 100)])
def test_bf16_bodies_match_their_plain_versions(dev, qt, D, metric):
    """Each bf16 body (K4 on whole partitions and with a chunk table, K5,
    K6 in both modes, K7, K8, K9, sized_topk, multi_topk, K3) against its
    plain version on the same bf16 operands (upcast, multiplied in f32) at
    the f32 tolerances; the launcher picks the tensor-core body where
    D % 8 == 0 (v4's chunk table its CUDA-core body), else the CUDA-core
    body. kk 10 and 33 (a sorted list's insert and merge), K4 also 100."""
    rng = np.random.default_rng(D + qt)
    bf, Gn = torch.bfloat16, 120
    tc = D % 8 == 0
    assert (rowscale_topk_body(qt, D, 100, dtype=bf) == MMA_BODY) == tc
    assert (rowscale_fold_body(qt, D, 10, bf) == MMA_BODY) == tc
    assert (exact_topk_body(qt, D, 33, bf) == K6_MMA_BODY) == tc
    assert (chunk_merge_body(qt, D, 33, bf) == K7_MMA_BODY) == tc
    assert (raw_scores_body(qt, D, bf) == MULTI_MMA_BODY) == tc
    assert (packed_topk_body(qt, D, 33, bf) == MULTI_MMA_BODY) == tc
    assert (sized_topk_body(qt, D, 33, bf) == MULTI_MMA_BODY) == tc
    assert (multi_topk_body(qt, D, 33, bf) == MULTI_MMA_BODY) == tc
    gp = torch.from_numpy(rng.integers(-1, 8, Gn).astype(np.int32)).to(dev)
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32)).to(dev).to(bf)
    for C in (512, 520):
        codes, norms, sizes, ids = _bf16_scan_store(dev, rng, C, D)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        for kk in (10, 100):
            _rowscale_bf16_agree((gp, gsize, qg, codes, norms, kk, slot_mult, levels, metric,
                                  "topk"))
        if C % 128 == 0:
            _rowscale_bf16_agree((gp, gsize, qg, codes, norms, 10, slot_mult, levels, metric,
                                  "fold"))
            for ct in (128, 256):
                sm, lv = packed_params(ct)
                _k7_agree((gp, gsize, qg, codes, norms, 33, ct, sm, lv, metric))
        elif D <= 128:  # K4 with a chunk table of ct 128, one query tile a group
            assert rowscale_topk_body(qt, D, 10, True, bf) == CHUNK_BODY
            ct, maxch = 128, -(-C // 128)
            cg_pid = gp[:30].repeat_interleave(maxch).contiguous()
            chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(30)
            cg_size = torch.where(cg_pid >= 0,
                                  (sizes[cg_pid.clamp(min=0).long()] - chunk * ct).clamp(0, ct),
                                  torch.zeros_like(cg_pid)).contiguous()
            qsrc = torch.arange(30, dtype=torch.int32, device=dev).repeat_interleave(maxch)
            sm, lv = packed_params(ct)
            _rowscale_bf16_agree((cg_pid, cg_size, qg[:30].contiguous(), codes, norms, 10, sm,
                                  lv, metric, "topk"), qsrc=qsrc.contiguous(),
                                 row_off=(chunk * ct).contiguous(), ct=ct)
        raw = raw_scores(gp, qg, codes, ids, metric)
        _k8_agree(raw, raw_scores_plain(gp, qg, codes, ids, metric))
        for kk in (10, 33):
            got = packed_topk(gp, qg, codes, ids, kk, metric)
            ref, _ = _k8_as_k9(gp, qg, codes, ids, kk, metric)
            _k9_agree(got, packed_topk_plain(gp, qg, codes, ids, kk, metric), ref,
                      slot_bits_of(C))
            _pairs_match(*sized_topk(gp, gsize, qg, codes, kk, metric),
                         *sized_topk_plain(gp, gsize, qg, codes, kk, metric), 1e-4)
            got_s, got_i = multi_topk(gp, qg, codes, ids, kk, metric, gb=2)
            want_s, want_i = multi_topk_plain(gp, qg, codes, ids, kk, metric)
            _pairs_match(got_s, got_i.masked_fill(got_i >= C, -1), want_s,
                         want_i.masked_fill(want_i >= C, -1), 1e-4)
            for mode, kw in (("slot", dict(group_size=gsize, norms=norms)),
                             ("id", dict(ids=ids))):
                _k6_agree(gp, qg, codes, kk, metric, mode, kw, models=(False,))
    cb = torch.from_numpy(rng.standard_normal((2048, D)).astype(np.float32)).to(dev).to(bf)
    bias = -(cb.float() ** 2).sum(1) if metric == "l2" else torch.zeros(2048, device=dev)
    bias[-20:] = float("-inf")
    qb = torch.from_numpy(rng.standard_normal((300, D)).astype(np.float32)).to(dev).to(bf)
    for N in (384, 2048):
        assert (flat_topk_body(N, D, bf) != CUDA_CORE_BODY) == tc
        got = flat_topk(cb[:N].contiguous(), bias[:N].contiguous(), qb, 16, metric)
        want = flat_topk_plain(cb[:N], bias[:N], qb, 16, metric)
        assert _overlap(got, want) >= 0.99


def _rowscale_bf16_agree(args, **chunk_table):
    """K4 or K5 on bf16 operands against its plain version: ghosts, stats
    within rtol = atol = 1e-4, winner overlap >= 0.99, common keys within
    one level."""
    gsize, kk, slot_mult = args[1], args[5], args[6]
    got, got_stats = rowscale_scan(*args, **chunk_table)
    want, want_stats = rowscale_scan_plain(*args, **chunk_table)
    torch.cuda.synchronize()
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    lanes = [torch.where(t >= 0, torch.remainder(t, slot_mult), -1.0) for t in (g, w)]
    assert _overlap(lanes[0], lanes[1]) >= 0.99
    same = (lanes[0] == lanes[1]) & (lanes[0] >= 0)
    assert ((torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()[same] <= 1).all()


@pytest.mark.parametrize("scan", ["v3p", "v3p4", "v6", "v7g4", "v4", "v5", "v3", "v2", "approx",
                                  "sized", "packed", "multi"])
def test_bf16_by_name_on_the_card_matches_its_cpu_load(dev, tmp_path, monkeypatch, scan):
    """A bf16 QuakeIndex built on the card, saved and loaded on the CPU:
    each scan by name through QuakeIndex.search (its _bf16 kernel launched,
    its f32 twin not; the parents ranked by K3 on both sides) and each
    direct scan on the store's tensors with the same probe lists, against
    the plain versions on the loaded copy: row overlap >= 0.99."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.ops import grouped_variants as gv

    rng = np.random.default_rng(29)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    q = rng.standard_normal((256, 64)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=32, precision="bf16", calibrate_aps=False))
    idx.save(str(tmp_path / "b"))
    cpu = QuakeIndex(device="cpu").load(str(tmp_path / "b"))
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    if scan in ("approx", "sized", "packed", "multi"):
        pids = torch.from_numpy(np.stack([rng.permutation(32)[:4] for _ in range(256)])
                                .astype(np.int32))
        runs = []
        for index, where in ((idx, dev), (cpu, torch.device("cpu"))):
            st = index.store.state
            args = (st.codes, st.ids) + ((st.sizes,) if scan == "sized" else ())
            runs.append(getattr(gv, f"grouped_scan_{scan}")(
                *args, torch.from_numpy(q).to(where), pids.to(where), 10, "l2", qt=16))
        got, want = runs[0][1].cpu(), runs[1][1]
        kernel = {"approx": "raw_scores", "sized": "sized_topk", "packed": "packed_topk",
                  "multi": "multi_topk"}[scan]
    else:
        monkeypatch.setenv("QUAKE_TPU_KERNEL", scan)
        sp = SearchParams(k=10, nprobe=4)
        _ext.reset_launches()
        got = torch.from_numpy(idx.search(q, sp).ids)
        launches = dict(_ext.launches)
        kernel = {"v3": "exact_topk", "v2": "exact_topk", "v5": "chunk_merge",
                  "v7g4": "rowscale_fold"}.get(scan, "rowscale_topk")
        assert launches[f"{kernel}_bf16"] >= 1 and launches[kernel] == 0, launches
        want = torch.from_numpy(cpu.search(q, sp).ids)
    assert _overlap(got, want) >= 0.99, kernel


# ----------------------------------------- K1 on the budget grid (v10b) and APS


def _budget_store(dev, rng, dtype, P=40, C=256, D=128, B=300, M=24):
    """A store with ghost (size-0) partitions and partial ones, rounded to
    dtype (f32 norms of the rounded codes), and a masked APS-style probe
    matrix with duplicate pids."""
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dtype)
    sizes = rng.integers(C // 3, C + 1, P).astype(np.int32)
    sizes[[3, 17]] = 0
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    ids[np.arange(C)[None, :] >= sizes[:, None]] = -1
    cf = codes.float()
    norms = (cf * cf).sum(-1)
    q = rng.standard_normal((B, D)).astype(np.float32)
    base = np.stack([rng.choice(P, M, replace=False) for _ in range(B)])
    n_b = rng.integers(1, M + 1, B)
    pids = np.where(np.arange(M)[None, :] < n_b[:, None], base, -1).astype(np.int32)
    pids[::5, 1] = pids[::5, 0]
    arrays = (codes, torch.from_numpy(ids), torch.from_numpy(sizes), norms, torch.from_numpy(q),
              torch.from_numpy(pids))
    return tuple(a.to(dev) for a in arrays), arrays


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placement", ["scatter", "sorted"])
def test_v10b_matches_its_cpu_run(dev, placement, dtype, exact):
    """grouped_scan_v10b on the card (K1 on the budget grid, f32 or bf16
    body, launches counted as grouped_scan_budget or _bf16; K2) against the same scan
    on a CPU copy (the plain versions): row overlap >= 0.99, common ids'
    scores within rtol = atol = 1e-4 (exact) or one key step (dequantized),
    scanned counts equal, at a generous and an exactly tight budget."""
    from quake_tpu_torch.ops.grouped_scan import global_bounds, grouped_scan_v10b, packed_params

    rng = np.random.default_rng(41)
    cuda, cpu = _budget_store(dev, rng, dtype)
    n_valid = int((cpu[-1] >= 0).sum())
    _, grange = global_bounds(cpu[4], cpu[3], "l2")
    step = float(grange) / packed_params(cpu[0].shape[1])[1]
    for bud in (n_valid + 200, n_valid):
        kw = dict(pair_budget=bud, qt=64, gpb=2, placement=placement, exact=exact)
        _ext.reset_launches()
        s_g, i_g, c_g = grouped_scan_v10b(*cuda, 10, "l2", **kw)
        torch.cuda.synchronize()
        k1 = "grouped_scan_budget_bf16" if dtype == torch.bfloat16 else "grouped_scan_budget"
        assert _ext.launches[k1] == 1 and _ext.launches["merge_positions"] == 1
        assert sum(_ext.launches[n] for n in _ext.KERNELS if n.startswith("grouped_scan")) == 1
        s_c, i_c, c_c = grouped_scan_v10b(*cpu, 10, "l2", **kw)
        assert torch.equal(c_g.cpu(), c_c)
        assert _overlap(i_g.cpu(), i_c) >= 0.99
        for a, sa, b, sb in zip(i_g.cpu().tolist(), s_g.cpu().tolist(), i_c.tolist(),
                                s_c.tolist()):
            theirs = dict(zip(b, sb))
            for i, sc in zip(a, sa):
                if i >= 0 and i in theirs:
                    tol = 1e-4 * (1.0 + abs(sc)) if exact else step + 1e-4 * (1.0 + abs(sc))
                    assert abs(sc - theirs[i]) <= tol


def test_v10b_equals_v10_on_the_card(dev):
    """With the budget holding every valid pair, the budgeted scatter scan
    is v10 on the same masked matrix: the same K1 rows, placed alike."""
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_v10, grouped_scan_v10b

    cuda, _ = _budget_store(dev, np.random.default_rng(43), torch.float32)
    n_valid = int((cuda[-1] >= 0).sum())
    s0, i0, c0 = grouped_scan_v10(*cuda, 10, "l2", qt=64, gpb=2)
    s1, i1, c1 = grouped_scan_v10b(*cuda, 10, "l2", pair_budget=n_valid, qt=64, gpb=2)
    assert torch.equal(c0, c1) and _overlap(i1.cpu(), i0.cpu()) >= 0.99


def test_aps_on_the_card_matches_its_cpu_load(dev, tmp_path, monkeypatch):
    """A default build on the card calibrates APS (v11: the budget stage
    runs); saved and loaded on the CPU, each recall-target mode returns the
    card's ids there (the plain versions; K3's for the fused oneshot's
    parents): overlap >= 0.99 and the same partitions scanned; the oneshot
    path launches K3, K2 and K1 (on the budget grid where a budget was
    calibrated)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    rng = np.random.default_rng(29)
    centers = 3.0 * rng.standard_normal((64, 64)).astype(np.float32)
    x = centers[rng.integers(0, 64, 30_000)] + rng.standard_normal((30_000, 64)).astype(np.float32)
    q = centers[rng.integers(0, 64, 1024)] + rng.standard_normal((1024, 64)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=64))
    assert idx.aps_radius_ab is not None and idx.aps_plan_width > 0
    idx.save(str(tmp_path / "aps"))
    cpu = QuakeIndex(device="cpu").load(str(tmp_path / "aps"))
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    for mode in ("oneshot", "planned", "loop"):
        sp = SearchParams(k=10, recall_target=0.95, aps_mode=mode)
        _ext.reset_launches()
        got = idx.search(q, sp)
        torch.cuda.synchronize()
        if mode == "oneshot":
            k1 = "grouped_scan_budget" if idx.aps_budget_w else "grouped_scan"
            assert _ext.launches[k1] == 1 and _ext.launches["flat_topk"] == 1
        want = cpu.search(q, sp)
        assert _overlap(torch.from_numpy(got.ids), torch.from_numpy(want.ids)) >= 0.99
        assert got.timing_info.partitions_scanned == want.timing_info.partitions_scanned


def test_profile_grouped_latency_runs_k1_where_jax_leaves_its_kernels(dev):
    """The latency profile on the card times kernel K1 (with K2) at every
    grid point, n = 16384 at D = 128 included: two of its slabs (16 MiB)
    pass the 12 MiB at which the JAX package profiles "xla" instead; K1
    serves it at gpb 1. k = 256 takes the widest selection."""
    from quake_tpu_torch.maintenance import ListScanLatencyEstimator

    est = ListScanLatencyEstimator(128, n_values=[64, 16384], k_values=[16, 256], n_trials=2,
                                   packaged=False)
    assert 2 * 16384 * 128 * 4 > (12 << 20)
    _ext.reset_launches()
    est.profile_grouped_latency(qt=32, device=dev)
    torch.cuda.synchronize()
    assert est.grid_source == "profiled" and (est.latency_grid > 0).all()
    # A point: two warm-up calls and the one captured in the CUDA graph (its
    # replays go through no wrapper).
    assert _ext.launches["grouped_scan"] >= 3 * 4 and _ext.launches["merge_positions"] >= 3 * 4
    # Device time: the larger slab costs more (the host clock read it flat).
    assert (est.latency_grid[1] > est.latency_grid[0]).all()
    _ext.reset_launches()
    ListScanLatencyEstimator(128, n_values=[16384], k_values=[16], n_trials=2) \
        .profile_grouped_latency(qt=32, device=dev)
    torch.cuda.synchronize()
    assert _ext.launches["grouped_scan"] >= 3  # the point the JAX package sends to "xla"


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_grouped_scan_under_sampled_bounds_matches_plain(dev, metric):
    """K1 on the key scale of bounds="sampled" (gmin from a sample of real
    scores: scores below it clamp to key 0 and stay candidates) against its
    plain version at K1's tolerances; with every score below the floor,
    equal to it (every live lane key 0); and v11 under it on the card
    against its CPU run (row overlap >= 0.99)."""
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_v11, v11_inputs

    cuda, cpu = _budget_store(dev, np.random.default_rng(47), torch.float32)
    codes, ids, sizes, norms, q, _ = cuda
    P = codes.shape[0]
    rng = np.random.default_rng(48)
    pids = torch.from_numpy(np.stack([rng.choice(P, 6, replace=False) for _ in range(q.shape[0])])
                            .astype(np.int32)).to(dev)
    inp = v11_inputs(codes, sizes, norms, q, pids, 10, metric, 64, 2, bounds="sampled")
    args = (inp["gp"], inp["group_size"], inp["qg"], codes, inp["normsT"], inp["kk"],
            inp["slot_mult"], inp["levels"])
    got, want = grouped_scan_kernel(*args), grouped_scan_plain(*args)
    torch.cuda.synchronize()
    sm = inp["slot_mult"]
    alive = inp["group_size"] > 0
    g, w = got[alive].reshape(-1, inp["kk"]), want[alive].reshape(-1, inp["kk"])
    gl = torch.where(g >= 0, torch.remainder(g, sm), torch.full_like(g, -1))
    wl = torch.where(w >= 0, torch.remainder(w, sm), torch.full_like(w, -1))
    assert _overlap(gl, wl) >= 0.99
    same = (gl == wl) & (gl >= 0)
    assert float((torch.floor(g / sm) - torch.floor(w / sm)).abs()[same].max()) <= 1.0
    # Every score below the floor: each lane below its size clamps to key 0
    # and stays a candidate (its packed value is its lane), as in the plain
    # version, bit for bit.
    low = (inp["normsT"] + float(inp["levels"]) + 2.0).contiguous()
    got = grouped_scan_kernel(*args[:4], low, *args[5:])
    want = grouped_scan_plain(*args[:4], low, *args[5:])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    live = got[alive]
    assert (live < sm).all() and (live[:, :, 0] >= 0).all()
    _, i_g, _ = grouped_scan_v11(*cuda[:5], pids, 10, metric, qt=64, gpb=2, bounds="sampled")
    _, i_c, _ = grouped_scan_v11(*cpu[:5], pids.cpu(), 10, metric, qt=64, gpb=2, bounds="sampled")
    assert _overlap(i_g.cpu(), i_c) >= 0.99


def test_three_level_index_on_the_card_matches_its_cpu_load(dev, tmp_path):
    """An index whose parent is itself an IVF, built on the card: every
    level valid; the fixed-nprobe search runs no kernel (the leaf's "xla"
    scan, as in the JAX package) and APS planned runs K1 (and K2 where a
    pool merges on it); saved and loaded on the CPU, both searches return
    the card's ids (overlap >= 0.99)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    rng = np.random.default_rng(31)
    centers = 3.0 * rng.standard_normal((64, 64)).astype(np.float32)
    x = centers[rng.integers(0, 64, 30_000)] + rng.standard_normal((30_000, 64)).astype(np.float32)
    q = centers[rng.integers(0, 64, 512)] + rng.standard_normal((512, 64)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=128, parent_params=IndexBuildParams(nlist=8)))
    assert idx.parent.parent is not None and idx.parent.nlist() == 8
    assert idx.validate() and idx.parent.validate() and idx.parent.parent.validate()
    idx.save(str(tmp_path / "ml"))
    cpu = QuakeIndex(device="cpu").load(str(tmp_path / "ml"))
    for sp in (SearchParams(k=10, nprobe=16),
               SearchParams(k=10, recall_target=0.9, aps_mode="planned")):
        _ext.reset_launches()
        got = idx.search(q, sp)
        torch.cuda.synchronize()
        ran = {k for k, v in _ext.launches.items() if v}
        if sp.recall_target > 0:
            assert ran & {"grouped_scan", "grouped_scan_budget"}
        else:
            assert not ran
        want = cpu.search(q, sp)
        assert _overlap(torch.from_numpy(got.ids), torch.from_numpy(want.ids)) >= 0.99


def test_maintenance_on_the_card_matches_its_cpu_load(dev, tmp_path):
    """An index with an aged region and a steep latency grid, saved and
    loaded on the card and on the CPU: the same host-recorded window makes
    the same splits and deletes on both (the batched 2-means and refinement
    on the card, their plain tensor programs on the CPU), with the same id
    set in every row and the centroids of both levels within 1e-4
    (index_add_'s float32 atomics add in no fixed order on the card)."""
    from quake_tpu_torch import IndexBuildParams, MaintenancePolicyParams, QuakeIndex
    from quake_tpu_torch.maintenance import ListScanLatencyEstimator

    x = np.random.default_rng(21).standard_normal((48_000, 8)).astype(np.float32)
    src = QuakeIndex(device="cpu")
    src.build(x, None, IndexBuildParams(nlist=16, calibrate_aps=False))
    sizes, active = src.store.partition_sizes(), src.store.active_rows()
    order = active[np.argsort(sizes[active], kind="stable")]
    for r in order[:3]:
        src.remove(src.store.get_partition(int(r))[1][3:])
    rest = order[3:]
    hot = [int(r) for r in rest[np.argsort(np.abs(sizes[rest] - sizes[rest].mean()),
                                           kind="stable")][:2]]
    grid = ListScanLatencyEstimator(8)
    grid.latency_grid = np.array([[n * 100.0 + k for k in grid.k_values] for n in grid.n_values])
    src.latency_profile = grid
    src.save(str(tmp_path / "aged"))
    card, cpu = (QuakeIndex(device=d).load(str(tmp_path / "aged")) for d in (dev, "cpu"))
    infos = []
    for idx in (card, cpu):
        idx.initialize_maintenance_policy(MaintenancePolicyParams(
            window_size=50, refinement_radius=8, min_partition_size=2))
        for _ in range(60):
            idx.maintenance_policy.record_query_hits(hot)
        infos.append(idx.maintenance())
        assert idx.validate() and idx.parent.ntotal() == idx.nlist()
    assert (infos[0].n_splits, infos[0].n_deletes) == (infos[1].n_splits, infos[1].n_deletes)
    assert infos[0].n_splits > 0 and infos[0].n_deletes > 0
    rows = {int(r): set(card.store.get_partition(int(r))[1].tolist())
            for r in card.store.active_rows()}
    assert rows == {int(r): set(cpu.store.get_partition(int(r))[1].tolist())
                    for r in cpu.store.active_rows()}
    for a, b in ((card, cpu), (card.parent, cpu.parent)):
        r = a.store.active_rows()
        np.testing.assert_array_equal(r, b.store.active_rows())
        np.testing.assert_allclose(a.store.state.centroids.cpu().numpy()[r],
                                   b.store.state.centroids.numpy()[r], rtol=1e-4, atol=1e-4)


def _two_copies_apart(idx):
    """Every id resident exactly twice, in two different partitions, the
    two maps naming those partitions (a spilled index's invariant)."""
    ids = idx.store.state.ids.cpu().numpy()
    rows, _ = np.nonzero(ids >= 0)
    flat = ids[ids >= 0].astype(np.int64)
    order = np.lexsort((rows, flat))
    flat, rows = flat[order], rows[order]
    assert len(flat) == 2 * idx.ntotal() and (flat[0::2] == flat[1::2]).all()
    assert (rows[0::2] != rows[1::2]).all()
    maps = np.sort(np.stack([idx.store.id_map.get_batch(flat[0::2]),
                             idx.store.spill_map.get_batch(flat[0::2])], 1), 1)
    assert (maps == np.stack([rows[0::2], rows[1::2]], 1)).all()


def test_spilled_index_on_the_card_matches_its_cpu_load(dev, tmp_path):
    """A SOAR-spilled index built on the CPU, saved, and loaded on the card
    and on the CPU: the card's fused search (K3 ranks the parents, K1 scans,
    the dedup tail merges; K2 does not launch) holds each id once a row and
    overlaps the CPU's by >= 0.99; the query-major B = 8 search and APS
    planned too. After one add and one remove both hold every id twice, in
    two different partitions. A spilled build on the card keeps the same
    invariant."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    rng = np.random.default_rng(31)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 64, 20_000)]
         + rng.standard_normal((20_000, 32)).astype(np.float32))
    q = (centers[rng.integers(0, 64, 256)]
         + rng.standard_normal((256, 32)).astype(np.float32))
    src = QuakeIndex(device="cpu")
    src.build(x, None, IndexBuildParams(nlist=32, spill=True))
    src.save(str(tmp_path / "spilled"))
    card, cpu = (QuakeIndex(device=d).load(str(tmp_path / "spilled")) for d in (dev, "cpu"))

    def no_dups(ids):
        return all(len(set(r[r >= 0].tolist())) == (r >= 0).sum() for r in ids)

    for sp, n in ((SearchParams(k=10, nprobe=6), 256), (SearchParams(k=10, nprobe=6), 8),
                  (SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5,
                                aps_mode="planned"), 256)):
        _ext.reset_launches()
        got = card.search(q[:n], sp).ids
        torch.cuda.synchronize()
        if n == 256 and sp.recall_target <= 0:
            assert _ext.launches["grouped_scan"] > 0 and _ext.launches["flat_topk"] > 0
            assert _ext.launches["merge_positions"] == 0
        want = cpu.search(q[:n], sp).ids
        assert no_dups(got) and no_dups(want)
        assert _overlap(got, want) >= 0.99
    for idx in (card, cpu):
        idx.add(x[:500] + 0.01, np.arange(50_000, 50_500))
        idx.remove(np.arange(0, 20_000, 3))
        assert idx.validate() and idx.ntotal() == 20_500 - len(range(0, 20_000, 3))
        _two_copies_apart(idx)
    built = QuakeIndex(device=dev)
    built.build(x, None, IndexBuildParams(nlist=32, spill=True))
    assert built.validate()
    _two_copies_apart(built)


def test_concurrent_searches_cuda(dev):
    """tests/test_stress.py::test_concurrent_searches on one CUDA index: 8
    threads search at once, each result equal to the serial one; every
    search launches K1, K2 and K3 once (the counts lose no update) and
    records its queries into the hit window."""
    import threading

    from quake_tpu_torch import IndexBuildParams, MaintenancePolicyParams, QuakeIndex
    from quake_tpu_torch import SearchParams

    rng = np.random.default_rng(5)
    x = rng.standard_normal((20_000, 32)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(20_000, dtype=np.int64), IndexBuildParams(nlist=16))
    idx.initialize_maintenance_policy(MaintenancePolicyParams(window_size=100_000))
    q = rng.standard_normal((64, 32)).astype(np.float32)
    sp = SearchParams(k=10, nprobe=8)
    expected = idx.search(q, sp).ids
    torch.cuda.synchronize()
    _ext.reset_launches()
    results = [None] * 8

    def worker(i):
        results[i] = [idx.search(q, sp).ids for _ in range(4)]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for r in results:
        for ids in r:
            np.testing.assert_array_equal(ids, expected)
    for name in ("grouped_scan", "merge_positions", "flat_topk"):
        assert _ext.launches[name] == 32, (name, _ext.launches[name])
    assert idx.maintenance_policy.hit_count_tracker.get_num_queries_recorded() == 33 * 64


@pytest.mark.parametrize("kernel", ["xla", "v11"])
def test_sharded_index_on_the_card_matches_its_cpu_load(dev, tmp_path, monkeypatch, kernel):
    """An index built on the CPU and saved, loaded on the card and sharded
    in two there (shard(2, devices=[cuda:0] * 2): two shards on one card),
    and loaded on the CPU and sharded over two virtual shards: under "xla"
    (both packages' scan off a TPU) the card's ids equal the CPU's, under
    the default v11 they overlap >= 0.99 (K1 sums in another order). The
    card's fixed-nprobe batch launches K1 and K2 once a shard and K3 never
    (the sharded route ranks the parents by the flat scan); the query-major
    B = 8 search, APS planned and loop, and a flat index sharded in two
    likewise. After an add and a remove each shard equals the primary's
    slot slice. A build with num_workers = the cards there are shards over
    all of them where there are two or more, else builds unsharded."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    if kernel == "xla":
        monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    else:
        monkeypatch.delenv("QUAKE_TPU_KERNEL", raising=False)
    rng = np.random.default_rng(37)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 64, 20_000)]
         + rng.standard_normal((20_000, 32)).astype(np.float32))
    q = (centers[rng.integers(0, 64, 256)]
         + rng.standard_normal((256, 32)).astype(np.float32))
    src = QuakeIndex(device="cpu")
    src.build(x, None, IndexBuildParams(nlist=32, calibrate_aps=False))
    src.save(str(tmp_path / "ivf"))
    flat = QuakeIndex(device="cpu")
    flat.build(x[:4096], None, IndexBuildParams(nlist=0))
    flat.save(str(tmp_path / "flat"))
    for name in ("ivf", "flat"):
        card = QuakeIndex(device=dev).load(str(tmp_path / name))
        card.shard(2, devices=[dev] * 2)
        cpu = QuakeIndex(device="cpu").load(str(tmp_path / name))
        cpu.shard(2)
        assert card.store.C == cpu.store.C and card.store.C % 256 == 0
        cases = ((SearchParams(k=10), 256),) if name == "flat" else (
            (SearchParams(k=10, nprobe=6), 256), (SearchParams(k=10, nprobe=6), 8),
            (SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5,
                          aps_mode="planned"), 256),
            (SearchParams(k=10, recall_target=0.9, initial_search_fraction=0.5,
                          aps_mode="loop"), 256))
        for sp, n in cases:
            torch.cuda.synchronize()
            _ext.reset_launches()
            got = card.search(q[:n], sp).ids
            torch.cuda.synchronize()
            if name == "ivf" and n == 256 and sp.recall_target <= 0 and kernel == "v11":
                assert _ext.launches["grouped_scan"] == 2 and _ext.launches["flat_topk"] == 0
                assert _ext.launches["merge_positions"] == 2
            want = cpu.search(q[:n], sp).ids
            if kernel == "xla":
                np.testing.assert_array_equal(got, want)
            else:
                assert _overlap(torch.from_numpy(got), torch.from_numpy(want)) >= 0.99
    card.load(str(tmp_path / "ivf"))
    card.shard(2, devices=[dev] * 2)
    card.add(x[:500] + 0.01, np.arange(50_000, 50_500))
    card.remove(np.arange(0, 20_000, 3))
    assert card.validate()
    st, sh = card.store.state, card._shards()
    Cl = card.store.C // 2
    for s in range(2):
        for f in ("codes", "ids", "norms"):
            assert torch.equal(getattr(sh, f)[s], getattr(st, f)[:, s * Cl:(s + 1) * Cl])
    n_cards = torch.cuda.device_count()
    built = QuakeIndex(device=dev)
    built.build(x, None, IndexBuildParams(nlist=32, num_workers=n_cards, calibrate_aps=False))
    if n_cards >= 2:
        assert built.mesh.size == n_cards and built.store.C % (128 * n_cards) == 0
    else:
        assert built.mesh is None
    assert built.search(q, SearchParams(k=10, nprobe=6)).ids.shape == (256, 10)


# ------------------------------------------- folds other than 128 (K1, K5)

# C = 1536 takes every fold of the served set below 768 (32, 64, 128 m for
# m = 1-4, 6): the sizes put the last segment in each fold block.
_FOLD_C = 1536
_FOLDS = (32, 64, 256, 384, 512, 768)
# (qt, D, codes dtype, tensor-core body): K1's and K5's tensor-core bodies at
# D = 128 and, streaming the depth, 768 (qt 32), their CUDA-core bodies at D
# = 30 (f32) and 100 (bf16).
_FOLD_SHAPES = [(64, 128, torch.float32, True), (32, 768, torch.float32, True),
                (8, 30, torch.float32, False), (64, 128, torch.bfloat16, True),
                (16, 100, torch.bfloat16, False)]


def _fold_inputs(rng, dev, qt, D, dtype, Gn=200):
    sizes_l = [0, 1, 128, 129, 300, 555, 700, 1000, 1300, _FOLD_C]
    P = len(sizes_l)
    codes = torch.from_numpy(rng.standard_normal((P, _FOLD_C, D)).astype(np.float32)).to(dev)
    codes = codes.to(dtype)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp)).contiguous()
    return codes, gp, gsize


@pytest.mark.parametrize("kk", [10, 100])
@pytest.mark.parametrize("fold", _FOLDS)
@pytest.mark.parametrize("qt,D,dtype,tc", _FOLD_SHAPES)
@pytest.mark.parametrize("budget", [False, True])
def test_grouped_scan_fold_matches_plain(dev, qt, D, dtype, tc, fold, kk, budget):
    """K1 at a fold other than 128 (its tensor-core and CUDA-core bodies, f32
    and bf16, and the budget grid's launch) against its plain version at the
    same fold: kk = 100 passes the 2 x 32 winners a row of fold 32 can give.
    One launch a call, under the name of fold 128's."""
    assert grouped_scan_uses_mma(qt, D, dtype, fold, kk) == tc
    rng = np.random.default_rng(qt + D + fold + kk)
    codes, gp, gsize = _fold_inputs(rng, dev, qt, D, dtype)
    slot_mult, levels = packed_params(_FOLD_C)
    scale = levels / (10.0 * D ** 0.5)
    Gn = gp.shape[0]
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, D)).astype(np.float32) * scale).to(dev)
    cf = codes.float()
    normsT = (((cf * cf).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
    args = (gp, gsize, qg.to(dtype).contiguous(), codes, normsT, kk, slot_mult, levels, fold)
    _ext.reset_launches()
    got = grouped_scan_kernel(*args, budget=budget)
    torch.cuda.synchronize()
    name = ("grouped_scan_budget" if budget else "grouped_scan") + (
        "_bf16" if dtype == torch.bfloat16 else "")
    assert _ext.launches[name] == 1 and sum(_ext.launches.values()) == 1
    alive = gsize > 0
    assert (got[~alive] == -1).all() and torch.isfinite(got).all()
    _packed_agree(got, grouped_scan_plain(*args), alive, slot_mult, kk)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kk", [10, 100])
@pytest.mark.parametrize("fold", _FOLDS)
@pytest.mark.parametrize("qt,D,dtype,tc", _FOLD_SHAPES)
def test_rowscale_fold_at_fold_matches_plain(dev, qt, D, dtype, tc, fold, kk, metric):
    """K5 at a fold other than 128 (tensor-core and CUDA-core bodies, f32 and
    bf16) against its plain version at the same fold: winners and stats."""
    assert (rowscale_fold_body(qt, D, kk, dtype, fold) == MMA_BODY) == tc
    rng = np.random.default_rng(qt + D + fold + kk + len(metric))
    codes, gp, gsize = _fold_inputs(rng, dev, qt, D, dtype)
    norms = (codes.float() ** 2).sum(-1).contiguous()
    qg = torch.from_numpy(rng.standard_normal((gp.shape[0], qt, D)).astype(np.float32)).to(dev)
    slot_mult, levels = packed_params(_FOLD_C)
    args = (gp, gsize, qg.to(dtype).contiguous(), codes, norms, kk, slot_mult, levels, metric,
            "fold")
    _ext.reset_launches()
    got, got_stats = rowscale_scan(*args, fold=fold)
    torch.cuda.synchronize()
    name = "rowscale_fold_bf16" if dtype == torch.bfloat16 else "rowscale_fold"
    assert _ext.launches[name] == 1 and sum(_ext.launches.values()) == 1
    alive = gsize > 0
    assert (got[~alive] == -1).all()
    want, want_stats = rowscale_scan_plain(*args, fold=fold)
    torch.testing.assert_close(got_stats, want_stats, rtol=1e-4, atol=1e-4)
    _packed_agree(got, want, alive, slot_mult, kk)


def test_fold_outside_the_served_set_raises_on_the_card(dev):
    rng = np.random.default_rng(3)
    codes, gp, gsize = _fold_inputs(rng, dev, 8, 32, torch.float32, Gn=4)
    qg = torch.zeros((4, 8, 32), device=dev)
    norms = (codes * codes).sum(-1).contiguous()
    slot_mult, levels = packed_params(_FOLD_C)
    with pytest.raises(ValueError, match="multiples of 128"):
        grouped_scan_kernel(gp, gsize, qg, codes, norms, 10, slot_mult, levels, 96)
    with pytest.raises(ValueError, match="multiples of 128"):
        rowscale_scan(gp, gsize, qg, codes, norms, 10, slot_mult, levels, "l2", "fold", fold=16)


# ------------------------------------------------- the grouping prologue

def _bits(t):
    """A tensor as integers: floats by their bit patterns, so that equality
    holds to every bit (signed zeros and NaNs included)."""
    if t.is_floating_point():
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t


def _probe_lists(rng, B, M, P, holes=0.0, dup=False, one=None):
    """[B, M] int32 probe lists: distinct partitions a row (as rank_parents
    gives them), -1 in a share `holes` of a row's tail (a per-query depth),
    the first probe repeated in every fifth row (dup), or every pair in
    partition `one`."""
    if one is not None:
        return np.full((B, M), one, np.int32)
    pids = (np.stack([rng.choice(P, M, replace=False) for _ in range(B)]) if M <= P
            else rng.integers(0, P, (B, M))).astype(np.int32)
    if holes:
        depth = rng.integers(max(1, int(M * (1 - 2 * holes))), M + 1, B)
        pids[np.arange(M)[None, :] >= depth[:, None]] = -1
    if dup:
        pids[::5, 1] = pids[::5, 0]
    return pids


# (B, M, P, C, D, codes dtype, pair budget, metric, bounds, pid pattern)
_GROUP_CASES = {
    "f32-batch16k": (16384, 14, 160, 6400, 128, torch.float32, 0, "l2", "analytic", {}),
    "bf16-batch16k": (16384, 14, 160, 6400, 128, torch.bfloat16, 0, "l2", "analytic", {}),
    "oneshot4k": (4096, 24, 1024, 1536, 128, torch.float32, 65536, "l2", "analytic",
                  dict(holes=0.45)),
    "churn-query": (100, 14, 160, 16384, 128, torch.float32, 0, "l2", "analytic", {}),
    "holes-dups": (600, 9, 40, 256, 16, torch.float32, 0, "ip", "analytic",
                   dict(holes=0.3, dup=True)),
    "budget-cut": (600, 9, 40, 256, 16, torch.bfloat16, 1500, "l2", "analytic",
                   dict(holes=0.3, dup=True)),
    "one-partition": (700, 5, 8, 256, 24, torch.float32, 0, "l2", "analytic", dict(one=3)),
    "P1": (333, 7, 1, 128, 8, torch.bfloat16, 0, "ip", "analytic", {}),
    "ragged-tile": (2731, 3, 37, 128, 13, torch.float32, 0, "l2", "sampled", dict(dup=True)),
}


@pytest.mark.parametrize("case", list(_GROUP_CASES))
def test_group_tables_kernel_matches_plain(dev, case):
    """The grouping kernels (group_count, group_scan, group_scatter,
    group_tables) against their plain version on the same card tensors,
    every output to every bit: gp, group_size and tgt (integers), qg (the
    scaled queries in the codes' dtype), normsT, gmin and ginv; the integer
    tables also against the plain version on the CPU, which the tier-1
    tests hold to the JAX package's build_groups_scatter and
    build_groups_budget. Cases: the cells' shapes, a churn query op (B=100),
    -1 pids and repeated pids in a row, a pair budget below the valid pairs,
    every pair in one partition, P = 1, and n = 8,193 pairs, past whole
    tiles (with the sampled bounds)."""
    from quake_tpu_torch.ops.grouped_scan import group_tables_kernel, group_tables_plain

    B, M, P, C, D, dtype, budget, metric, bounds, pattern = _GROUP_CASES[case]
    rng = np.random.default_rng(len(case) + B)
    pids = torch.from_numpy(_probe_lists(rng, B, M, P, **pattern))
    if budget:
        assert budget < B * M
    if case == "budget-cut":
        assert budget < int((pids >= 0).sum())
    codes = torch.from_numpy(rng.standard_normal((P, C, D)).astype(np.float32)).to(dtype)
    sizes = torch.from_numpy(rng.integers(0, C + 1, P).astype(np.int32))
    cf = codes.float()
    norms = (cf * cf).sum(-1) * (torch.arange(C)[None, :] < sizes[:, None].long())
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32) * 3.0)
    levels = packed_params(C)[1]
    cuda = [t.to(dev).contiguous() for t in (codes, sizes, norms, q, pids)]
    args = (metric, 64, 4, levels, bounds, budget)
    _ext.reset_launches()
    got = group_tables_kernel(*cuda, *args)
    torch.cuda.synchronize()
    assert {n: c for n, c in _ext.launches.items() if c} == {
        "group_count": 1, "group_scan": 1, "group_scatter": 1, "group_tables": 1}
    want = group_tables_plain(*cuda, *args)
    cpu = group_tables_plain(codes, sizes, norms, q, pids, *args)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(_bits(got[key]), _bits(want[key])), key
    for key in ("gp", "group_size", "tgt"):
        assert torch.equal(got[key].cpu(), cpu[key]), key
    assert (got["gp"] >= 0).any()


def test_search_grouping_span_launches(dev):
    """A search on the card builds its tables in the grouping kernels, and
    the span quake.plan.grouping issues at most 12 launches a call."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.profiling import device_trace, last_spans

    rng = np.random.default_rng(12)
    x = rng.standard_normal((8192, 32)).astype(np.float32)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=16, calibrate_aps=False))
    q = x[:512] + 0.1 * rng.standard_normal((512, 32)).astype(np.float32)
    sp = SearchParams(k=10, nprobe=4)
    idx.search(q, sp)
    torch.cuda.synchronize()
    _ext.reset_launches()
    with device_trace():
        idx.search(q, sp)
        torch.cuda.synchronize()
    assert _ext.launches["group_tables"] == 1
    row = last_spans()["quake.plan.grouping"]
    assert row["calls"] == 1 and 0 < row["launches"] <= 12
