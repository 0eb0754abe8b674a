"""The four grouped scans with entry points of their own (approx, sized,
packed, multi), quake_tpu_torch against the JAX package on the same inputs
(CPU).

The JAX side runs its Pallas kernels in interpret mode; the torch side runs
the plain PyTorch versions of kernels K8, K9, sized_topk and multi_topk (the
wrappers take them for CPU tensors). Inputs come from numpy seeds and go to
both packages as numpy.

Tolerances: scores within rtol = atol = 1e-5 (one f32 dot product summed in
another order; 1e-4 for the packed scan, whose scores are rescored from
gathered vectors), id sets equal per row, scanned counts equal. The packed
kernel's values carry the top bits of the score's bit pattern, which the
other order of summation can move in the last place: slots compare by
overlap and keys within one unit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quake_tpu.ops import pallas_grouped as jpg
from quake_tpu_torch.ops import grouped_variants as gv
from quake_tpu_torch.ops.grouped import build_groups

VARIANTS = ("approx", "sized", "packed", "multi")


def _t(a):
    return torch.from_numpy(np.array(a))


def _store(P, C, D, seed, sizes, poison):
    """Compact-prefix store; the rows past each size hold `poison` and no id."""
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = rng.permutation(P * C).astype(np.int32).reshape(P, C)
    sizes = np.asarray(sizes, np.int32)
    for p in range(P):
        ids[p, sizes[p]:] = -1
        codes[p, sizes[p]:] = poison
    return codes, ids, sizes


def _run_both(variant, codes, ids, sizes, q, pids, k, metric, qt, ct=32, gb=4):
    """(JAX result, torch result) of one entry point, as numpy triples."""
    jc, ji, js, jq, jp = (jnp.asarray(a) for a in (codes, ids, sizes, q, pids))
    tc, ti, ts, tq, tp = (_t(a) for a in (codes, ids, sizes, q, pids))
    if variant == "approx":
        want = jpg.grouped_scan_pallas_approx(jc, ji, jq, jp, k, metric, qt=qt, interpret=True)
        got = gv.grouped_scan_approx(tc, ti, tq, tp, k, metric, qt=qt)
    elif variant == "sized":
        # The TPU kernel copies whole tiles, so a ct that does not divide C
        # reaches past its slab; the result does not depend on ct, so the JAX
        # side then runs a ct that divides.
        want = jpg.grouped_scan_pallas_sized(jc, ji, js, jq, jp, k, metric, qt=qt,
                                             ct=ct if codes.shape[1] % ct == 0 else 32,
                                             interpret=True)
        got = gv.grouped_scan_sized(tc, ti, ts, tq, tp, k, metric, qt=qt, ct=ct)
    elif variant == "packed":
        want = jpg.grouped_scan_pallas_packed(jc, ji, jq, jp, k, metric, qt=qt, interpret=True)
        got = gv.grouped_scan_packed(tc, ti, tq, tp, k, metric, qt=qt)
    else:
        want = jpg.grouped_scan_pallas_multi(jc, ji, jq, jp, k, metric, qt=qt, gb=gb,
                                             interpret=True)
        got = gv.grouped_scan_multi(tc, ti, tq, tp, k, metric, qt=qt, gb=gb)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_same(variant, want, got, ids, pids):
    (s1, i1, n1), (s2, i2, n2) = want, got
    tol = 1e-4 if variant == "packed" else 1e-5
    assert s2.shape == s1.shape and i2.shape == i1.shape
    assert i2.dtype == np.int32 and n2.dtype == np.int32
    np.testing.assert_allclose(s2, s1, rtol=tol, atol=tol)
    np.testing.assert_array_equal(n2, n1)
    for b in range(len(i1)):
        assert set(i2[b].tolist()) == set(i1[b].tolist()), b
        allowed = ids[pids[b][pids[b] >= 0]]
        assert np.isin(i2[b][i2[b] >= 0], allowed[allowed >= 0]).all()
    assert np.isneginf(s2[i2 < 0]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_entry_point_matches_jax(variant, metric):
    """The shapes of the JAX package's own tests of these entry points."""
    rng = np.random.default_rng(1)
    P, C, D, B, nprobe, k, qt = 8, 128, 16, 12, 3, 5, 8
    sizes = rng.integers(C // 2, C + 1, P)
    codes, ids, sizes = _store(P, C, D, 2, sizes, 999.0 if variant == "sized" else 10.0)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(0, P, (B, nprobe)).astype(np.int32)
    pids[0, 1:] = -1
    want, got = _run_both(variant, codes, ids, sizes, q, pids, k, metric, qt)
    _assert_same(variant, want, got, ids, pids)


EDGES = {
    # name: (sizes of the 8 partitions, k, qt, ct, gb)
    "empty_and_short": ([128, 0, 3, 1, 128, 70, 0, 127], 5, 8, 32, 4),
    "k_above_C": ([128, 90, 128, 40, 128, 128, 64, 128], 150, 8, 64, 4),
    "ct_and_gb_do_not_divide": ([128, 100, 5, 128, 33, 128, 97, 128], 7, 16, 48, 5),
}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_entry_point_edges_match_jax(variant, edge, metric):
    """Poisoned rows past the size, empty partitions and partitions below k,
    a query whose probes are all -1 but one and one with no probe, k > C, a
    tile height that does not divide C and a gb that does not divide the
    group count."""
    sizes, k, qt, ct, gb = EDGES[edge]
    P, C, D, B, nprobe = 8, 128, 16, 20, 4
    codes, ids, sizes = _store(P, C, D, 3, sizes, 999.0 if variant == "sized" else 10.0)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    pids[0, 1:] = -1
    pids[1, :3] = -1
    pids[2, :] = -1
    pids[3, :] = 1  # only the empty (or short) partition, four times
    G = build_groups(_t(pids), P, qt)[0].shape[0]
    assert C % ct != 0 or edge != "ct_and_gb_do_not_divide"
    assert G % gb != 0 or edge != "ct_and_gb_do_not_divide"
    want, got = _run_both(variant, codes, ids, sizes, q, pids, k, metric, qt, ct, gb)
    _assert_same(variant, want, got, ids, pids)


def test_sized_result_does_not_depend_on_ct():
    P, C, D, B, nprobe, k, qt = 8, 200, 16, 16, 3, 6, 8
    rng = np.random.default_rng(5)
    codes, ids, sizes = _store(P, C, D, 6, rng.integers(0, C + 1, P), 999.0)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(0, P, (B, nprobe)).astype(np.int32)
    args = (_t(codes), _t(ids), _t(sizes), _t(q), _t(pids), k, "l2")
    ref = gv.grouped_scan_sized(*args, qt=qt, ct=200)
    for ct in (7, 64, 128, 256):
        out = gv.grouped_scan_sized(*args, qt=qt, ct=ct)
        torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(out[1], ref[1])


# ---------------------------------------- plain kernel versions vs Pallas


def _kernel_inputs(metric, qt, gb=1, seed=7):
    """The port's own group tensors for a small store, as numpy."""
    P, C, D, B, nprobe = 8, 128, 16, 20, 3
    sizes = [128, 0, 77, 1, 128, 64, 12, 100]
    codes, ids, sizes = _store(P, C, D, seed, sizes, 10.0)
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = rng.integers(-1, P, (B, nprobe)).astype(np.int32)
    gp, qg, _, _ = gv._groups(_t(q), _t(pids), P, qt, torch.float32, gb)
    gsize = np.where(gp.numpy() >= 0, sizes[np.maximum(gp.numpy(), 0)], 0).astype(np.int32)
    return codes, ids, gp.numpy(), gsize, qg.numpy()


def _slab_specs(qt, C, D):
    return [pl.BlockSpec((1, qt, D), lambda g, gp: (g, 0, 0)),
            pl.BlockSpec((1, C, D), lambda g, gp: (jnp.maximum(gp[g], 0), 0, 0)),
            pl.BlockSpec((1, 1, C), lambda g, gp: (jnp.maximum(gp[g], 0), 0, 0))]


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_raw_scores_plain_matches_pallas_kernel(metric):
    qt = 8
    codes, ids, gp, _, qg = _kernel_inputs(metric, qt)
    G, (P, C, D) = gp.shape[0], codes.shape
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G,), in_specs=_slab_specs(qt, C, D),
        out_specs=[pl.BlockSpec((1, qt, C), lambda g, gp: (g, 0, 0))])
    (want,) = pl.pallas_call(
        jpg._scores_kernel(metric), grid_spec=spec,
        out_shape=[jax.ShapeDtypeStruct((G, qt, C), jnp.float32)], interpret=True,
    )(jnp.asarray(gp), jnp.asarray(qg), jnp.asarray(codes), jnp.asarray(ids).reshape(P, 1, C))
    got = gv.raw_scores(_t(gp), _t(qg), _t(codes), _t(ids), metric).numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[gp < 0]).all() and np.isneginf(got).any() and np.isfinite(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_packed_topk_plain_matches_pallas_kernel(metric):
    qt, kk = 8, 6
    codes, ids, gp, _, qg = _kernel_inputs(metric, qt)
    G, (P, C, D) = gp.shape[0], codes.shape
    slot_bits = gv.slot_bits_of(C)
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G,), in_specs=_slab_specs(qt, C, D),
        out_specs=[pl.BlockSpec((1, qt, kk), lambda g, gp: (g, 0, 0))])
    (want,) = pl.pallas_call(
        jpg._packed_kernel(metric, kk, slot_bits), grid_spec=spec,
        out_shape=[jax.ShapeDtypeStruct((G, qt, kk), jnp.int32)], interpret=True,
    )(jnp.asarray(gp), jnp.asarray(qg), jnp.asarray(codes), jnp.asarray(ids).reshape(P, 1, C))
    got = gv.packed_topk(_t(gp), _t(qg), _t(codes), _t(ids), kk, metric).numpy()
    want = np.asarray(want)
    live = gp >= 0  # the TPU kernel still selects in a ghost group; its wrapper masks it
    assert (got[~live] == -1).all()
    got, want = got[live], want[live]
    np.testing.assert_array_equal(got >= 0, want >= 0)
    assert (np.diff(got, axis=2) <= 0).all() and (got >= -1).all()
    mask = (1 << slot_bits) - 1
    same_slot = ((got & mask) == (want & mask)) & (got >= 0)
    assert same_slot.mean() >= 0.99 * (got >= 0).mean()
    assert np.abs((got >> slot_bits) - (want >> slot_bits))[same_slot].max() <= 1
    assert (got == want).mean() >= 0.95


@pytest.mark.parametrize("ct", [32, 48])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sized_topk_plain_matches_pallas_kernel(metric, ct):
    qt, kk = 8, 6
    codes, ids, gp, gsize, qg = _kernel_inputs(metric, qt)
    G, (P, C, D) = gp.shape[0], codes.shape
    # The TPU kernel copies whole tiles: give it a slab padded to a multiple of ct.
    Cp = -(-C // ct) * ct
    codes_p = np.concatenate([codes, np.full((P, Cp - C, D), 10.0, np.float32)], axis=1)
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(G,),
        in_specs=[pl.BlockSpec((1, qt, D), lambda g, gp, gs: (g, 0, 0)),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=[pl.BlockSpec((1, qt, kk), lambda g, gp, gs: (g, 0, 0)),
                   pl.BlockSpec((1, qt, kk), lambda g, gp, gs: (g, 0, 0))],
        scratch_shapes=[pltpu.VMEM((2, ct, D), jnp.float32), pltpu.SemaphoreType.DMA((2,))])
    want_s, want_i = pl.pallas_call(
        jpg._sized_kernel(metric, kk, ct, Cp // ct), grid_spec=spec,
        out_shape=[jax.ShapeDtypeStruct((G, qt, kk), jnp.float32),
                   jax.ShapeDtypeStruct((G, qt, kk), jnp.int32)], interpret=True,
    )(jnp.asarray(gp), jnp.asarray(gsize), jnp.asarray(qg), jnp.asarray(codes_p))
    got_s, got_i = gv.sized_topk(_t(gp), _t(gsize), _t(qg), _t(codes), kk, metric, ct=ct)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i.numpy()[np.isneginf(got_s.numpy())] == -1).all()
    assert (got_i.numpy() < gsize[:, None, None]).all()


@pytest.mark.parametrize("gb", [1, 3])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_multi_topk_plain_matches_pallas_kernel(metric, gb):
    qt, kk = 8, 6
    codes, ids, gp, _, qg = _kernel_inputs(metric, qt, gb=gb)
    G, (P, C, D) = gp.shape[0], codes.shape
    assert G % gb == 0
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G // gb,),
        in_specs=[pl.BlockSpec((gb, qt, D), lambda g, gp_: (g, 0, 0)),
                  pl.BlockSpec(memory_space=pltpu.ANY), pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=[pl.BlockSpec((gb, qt, kk), lambda g, gp_: (g, 0, 0)),
                   pl.BlockSpec((gb, qt, kk), lambda g, gp_: (g, 0, 0))],
        scratch_shapes=[pltpu.VMEM((2, C, D), jnp.float32), pltpu.VMEM((2, 1, C), jnp.int32),
                        pltpu.SemaphoreType.DMA((2,)), pltpu.SemaphoreType.DMA((2,))])
    want_s, want_i = pl.pallas_call(
        jpg._multi_kernel(metric, kk, gb, C, D), grid_spec=spec,
        out_shape=[jax.ShapeDtypeStruct((G, qt, kk), jnp.float32),
                   jax.ShapeDtypeStruct((G, qt, kk), jnp.int32)], interpret=True,
    )(jnp.asarray(gp), jnp.asarray(qg), jnp.asarray(codes), jnp.asarray(ids).reshape(P, 1, C))
    got_s, got_i = gv.multi_topk(_t(gp), _t(qg), _t(codes), _t(ids), kk, metric, gb=gb)
    got_s, got_i, want_s, want_i = (np.asarray(a) for a in (got_s, got_i, want_s, want_i))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    # Past a row's valid lanes the TPU kernel leaves an arbitrary lane.
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(got_i[finite], want_i[finite])
    assert (got_i[~finite] == C).all()


# ------------------------------------------------------------------ guards


def _meta_args(name):
    Gn, qt, D, P, C = 4, 8, 16, 2, 128
    gp = torch.zeros(Gn, dtype=torch.int32, device="meta")
    qg = torch.zeros((Gn, qt, D), device="meta")
    codes = torch.zeros((P, C, D), device="meta")
    ids = torch.zeros((P, C), dtype=torch.int32, device="meta")
    return {"raw_scores": (gp, qg, codes, ids, "l2"),
            "packed_topk": (gp, qg, codes, ids, 5, "l2"),
            "sized_topk": (gp, gp, qg, codes, 5, "l2"),
            "multi_topk": (gp, qg, codes, ids, 5, "l2", 2)}[name]


@pytest.mark.parametrize("name", ["raw_scores", "packed_topk", "sized_topk", "multi_topk"])
def test_kernel_wrappers_reject_other_devices(name):
    """Only a CPU tensor takes the plain version; anything else but CUDA raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(gv, name)(*_meta_args(name))


def test_argument_guards():
    gp = torch.zeros(4, dtype=torch.int32)
    qg, codes = torch.zeros((4, 8, 16)), torch.zeros((2, 128, 16))
    ids = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of gb"):
        gv.multi_topk(gp, qg, codes, ids, 5, "l2", gb=3)
    with pytest.raises(ValueError, match="ct must be positive"):
        gv.sized_topk(gp, gp, qg, codes, 5, "l2", ct=0)
    with pytest.raises(ValueError, match="P < 32768"):
        gv.grouped_scan_packed(torch.zeros((32768, 1, 2)), torch.zeros((32768, 1), dtype=torch.int32),
                               torch.zeros((2, 2)), torch.zeros((2, 1), dtype=torch.int32), 1, "l2")


def test_pack_scores_is_monotone_and_positive():
    s = torch.tensor([[-3.5, -0.0, 0.0, 1e-30, 2.0, 2.0000002, 1e30, -1e30]])
    packed = gv.pack_scores(s, 3)
    assert (packed >= 0).all() and (packed & 7).tolist() == [list(range(8))]
    key = (packed >> 3)[0]
    order = torch.argsort(s[0], stable=True)
    assert (torch.diff(key[order]) >= 0).all()
    assert key[1] < key[2]  # -0.0 sorts below +0.0 in the bit-pattern order
