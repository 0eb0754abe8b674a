"""Kernel K9's selection order and the plain versions of K8 and K9 on the
split product's model (CPU).

On the tensor cores K9 (packed_topk) runs the body of the exact selections
(csrc/pair_topk_mma.cuh, mode kPacked): each valid lane enters a row's list
as the pair (0, packed value), and the lists keep the kk best pairs in the
pair order of csrc/common.cuh::pair_above (score, then the larger index).
The first test holds that order, written out in plain Python, to
`torch.topk` of `pack_scores`, which is what the JAX package's
_packed_kernel selects (kk rounds of a maximum over distinct values).

K8 (raw_scores) and K9 multiply on the tensor cores in split TF32
(ops/split_product.py is the plain model); the other tests run their plain
versions on that model against quake_tpu's Pallas _scores_kernel and
_packed_kernel in interpret mode.

Tolerances: the pair order's top kk equals torch.topk's exactly (integer
order, no arithmetic). Scores within rtol = atol = 1e-4 (SCORE_TOL of
chip_smoke.py: the split product against the TPU kernel's f32 product,
summed in another order); the packed winners' lanes overlap >= 0.99 (a
packed value carries the top bits of the score's bit pattern, which the
other order moves in the last place) and their keys differ by at most one
unit.
"""

from functools import cmp_to_key

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu_torch.ops import grouped_variants as gv
from quake_tpu_torch.ops.split_product import bmm_as_split_product

SCORE_TOL = 1e-4
OVERLAP_TOL = 0.99


def _t(a):
    return torch.from_numpy(np.array(a))


def pair_above(a, b):
    """csrc/common.cuh::pair_above on (score, index) pairs."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] > b[1])


def kpacked_pairs(scores, valid, slot_bits: int):
    """The pairs one row of mode kPacked selects among: (0.0, the lane's
    packed value) for each valid lane."""
    packed = gv.pack_scores(scores, slot_bits).tolist()
    return [(0.0, p) for p, ok in zip(packed, valid.tolist()) if ok]


def pair_topk(pairs, kk: int):
    """The kk best pairs in the pair order, best first; what a row's sorted
    list holds at the end, with the empty entries as (-inf, -1)."""
    order = cmp_to_key(lambda a, b: -1 if pair_above(a, b) else int(pair_above(b, a)))
    best = sorted(pairs, key=order)[:kk]
    return best + [(float("-inf"), -1)] * (kk - len(best))


def _row_scores(rng, C: int):
    """Scores with negatives, +0 and -0, runs of equal scores, large and
    tiny magnitudes, and lanes without a vector."""
    s = rng.standard_normal(C).astype(np.float32) * 3.0
    s[rng.integers(0, C, C // 8)] = 0.0
    s[rng.integers(0, C, C // 8)] = -0.0
    s[rng.integers(0, C, C // 8)] = s[0]  # equal scores
    s[rng.integers(0, C, C // 16)] = rng.choice([3e38, -3e38, 1e-38, -1e-38, 7e30], C // 16)
    valid = rng.random(C) > 0.2
    return _t(s), _t(valid)


@pytest.mark.parametrize("C", [64, 65, 200, 7552])
def test_kpacked_pair_order_is_the_packed_int_order(C):
    """slot_bits 6, 7, 8 and 13: the pair order's top kk of (0, packed)
    equals torch.topk of pack_scores over the valid lanes (-1 elsewhere), at
    kk = 1, 10, 100 and all of C; and the packed values would not survive as
    float scores: f32 holds 24 bits, a packed value 31."""
    rng = np.random.default_rng(C)
    bits = gv.slot_bits_of(C)
    for _ in range(3):
        scores, valid = _row_scores(rng, C)
        packed = torch.where(valid, gv.pack_scores(scores, bits), -1)
        pairs = kpacked_pairs(scores, valid, bits)
        for kk in sorted({1, 10, min(100, C), C}):
            got = [i for _, i in pair_topk(pairs, kk)]
            assert got == torch.topk(packed, kk).values.tolist()
        live = packed[packed >= 0]
        assert live.unique().numel() == live.numel()  # distinct: the order is total
        assert live.to(torch.float32).unique().numel() < live.numel()


# ---------------------------------- plain versions on the split product's model


def _kernel_inputs(metric, qt, seed):
    """Groups over a store whose rows past each size hold poison and no id
    (C = 256: two segments; D = 64), as numpy."""
    P, C, D, B, nprobe = 6, 256, 64, 24, 3
    sizes = [256, 0, 77, 1, 129, 150]
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = rng.permutation(P * C).astype(np.int32).reshape(P, C)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = 10.0
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(-1, P, (B, nprobe)).astype(np.int32)
    gp, qg, _, _ = gv._groups(_t(q), _t(pids), P, qt, torch.float32)
    return codes, ids, gp.numpy(), qg.numpy()


def _pallas(kernel, out_shape, out_block, gp, qg, codes, ids):
    G, qt, D = qg.shape
    P, C, _ = codes.shape
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G,),
        in_specs=[pl.BlockSpec((1, qt, D), lambda g, gp: (g, 0, 0)),
                  pl.BlockSpec((1, C, D), lambda g, gp: (jnp.maximum(gp[g], 0), 0, 0)),
                  pl.BlockSpec((1, 1, C), lambda g, gp: (jnp.maximum(gp[g], 0), 0, 0))],
        out_specs=[pl.BlockSpec(out_block, lambda g, gp: (g, 0, 0))])
    (out,) = pl.pallas_call(kernel, grid_spec=spec, out_shape=[out_shape], interpret=True)(
        jnp.asarray(gp), jnp.asarray(qg), jnp.asarray(codes), jnp.asarray(ids).reshape(P, 1, C))
    return np.asarray(out)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_raw_scores_plain_on_the_split_product_matches_pallas(metric):
    """K8's plain version on the split product's model against
    _scores_kernel: the same -inf lanes, scores within SCORE_TOL."""
    qt = 8
    codes, ids, gp, qg = _kernel_inputs(metric, qt, seed=61)
    G, C = gp.shape[0], codes.shape[1]
    want = _pallas(jpg._scores_kernel(metric), jax.ShapeDtypeStruct((G, qt, C), jnp.float32),
                   (1, qt, C), gp, qg, codes, ids)
    with bmm_as_split_product():
        got = gv.raw_scores_plain(_t(gp), _t(qg), _t(codes), _t(ids), metric).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(got).any() and np.isneginf(got[gp < 0]).all()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_packed_topk_plain_on_the_split_product_matches_pallas(metric):
    """K9's plain version on the split product's model against
    _packed_kernel: as many winners a row, descending, lanes overlap
    >= OVERLAP_TOL, keys of common lanes within one unit."""
    qt, kk = 8, 12
    codes, ids, gp, qg = _kernel_inputs(metric, qt, seed=67)
    G, C = gp.shape[0], codes.shape[1]
    bits = gv.slot_bits_of(C)
    want = _pallas(jpg._packed_kernel(metric, kk, bits), jax.ShapeDtypeStruct((G, qt, kk),
                                                                              jnp.int32),
                   (1, qt, kk), gp, qg, codes, ids)
    with bmm_as_split_product():
        got = gv.packed_topk_plain(_t(gp), _t(qg), _t(codes), _t(ids), kk, metric).numpy()
    live = gp >= 0  # the TPU kernel still selects in a ghost group; its wrapper masks it
    assert (got[~live] == -1).all()
    got, want = got[live], want[live]
    np.testing.assert_array_equal(got >= 0, want >= 0)
    assert (np.diff(got, axis=2)[got[..., 1:] >= 0] < 0).all()
    mask = (1 << bits) - 1
    gl, wl = (np.where(a >= 0, a & mask, -1).reshape(-1, kk) for a in (got, want))
    shared = [len(set(a[a >= 0]) & set(b[b >= 0])) / max(int((b >= 0).sum()), 1)
              if (b >= 0).any() else float(not (a >= 0).any()) for a, b in zip(gl, wl)]
    assert np.mean(shared) >= OVERLAP_TOL
    same = (gl == wl) & (gl >= 0)
    keys = [a.reshape(-1, kk) >> bits for a in (got, want)]
    assert np.abs(keys[0] - keys[1])[same].max() <= 1
