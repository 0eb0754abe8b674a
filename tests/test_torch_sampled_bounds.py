"""bounds="sampled", the global key scale of v8, v9, v10, v11 and v10b from a
sample of real scores (pallas_grouped.py::_global_bounds), in the port
against the JAX package, on the CPU.

What is held, and how closely:
  * global_bounds against _global_bounds on the same store: gmin and grange
    equal at rtol 1e-5 (the sample's product is a plain matmul in both, f32
    sums in another order), on full and partly filled partitions, l2 and ip,
    B above and below the 64-query sample;
  * each scan's plain version (kernel K1's on the CPU) with sampled bounds
    against the JAX Pallas function in interpret mode: per-row overlap of
    ids >= k - 1 (tests/test_pallas_grouped.py::
    test_v9_sampled_bounds_interpret's gate) and >= k - 1 against the exact
    "xla" scan, ids of the common rows' distances within 1e-4 (exact
    rescore);
  * a lane whose score falls below the sampled gmin clamps to key 0 and
    stays a candidate (packed value = its lane, not -1), as in K1's bodies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu.ops.grouped import grouped_scan_xla
from quake_tpu.ops.pallas_grouped import (_global_bounds, grouped_scan_pallas_v8,
                                          grouped_scan_pallas_v9, grouped_scan_pallas_v10,
                                          grouped_scan_pallas_v10b, grouped_scan_pallas_v11)
from quake_tpu_torch.ops.grouped_family import grouped_scan_v8, grouped_scan_v9
from quake_tpu_torch.ops.grouped_scan import (global_bounds, grouped_scan_plain, grouped_scan_v10,
                                              grouped_scan_v10b, grouped_scan_v11, packed_params)

K, QT = 5, 8


def _store(seed, P=8, C=256, D=16, B=16, nprobe=4, partial=False):
    """tests/test_pallas_grouped.py::test_v9_sampled_bounds_interpret's
    store (seed 13: full partitions), or one with partitions partly filled."""
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    sizes = (rng.integers(C // 4, C, P) if partial else np.full(P, C)).astype(np.int32)
    ids = np.full((P, C), -1, np.int32)
    for p in range(P):
        ids[p, :sizes[p]] = np.arange(sizes[p]) + p * C
        codes[p, sizes[p]:] = 0.0
    norms = (codes ** 2).sum(axis=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    return codes, ids, sizes, norms, q, pids


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,partial", [(16, False), (200, True)])
def test_global_bounds_match_jax(metric, B, partial):
    codes, _, sizes, norms, q, _ = _store(5, B=B, partial=partial)
    want = _global_bounds(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(norms),
                          jnp.asarray(sizes), metric, "sampled")
    got = global_bounds(torch.from_numpy(q), torch.from_numpy(norms), metric, "sampled",
                        codes=torch.from_numpy(codes), sizes=torch.from_numpy(sizes))
    np.testing.assert_allclose([float(a) for a in got], [float(a) for a in want], rtol=1e-5)
    analytic = global_bounds(torch.from_numpy(q), torch.from_numpy(norms), metric)
    assert float(got[1]) < float(analytic[1])  # a tighter range: more levels a score
    with pytest.raises(ValueError, match="codes and sizes"):
        global_bounds(torch.from_numpy(q), torch.from_numpy(norms), metric, "sampled")


def _run_jax(name, arrays, kw):
    fn = dict(v8=grouped_scan_pallas_v8, v9=grouped_scan_pallas_v9, v10=grouped_scan_pallas_v10,
              v11=grouped_scan_pallas_v11, v10b=grouped_scan_pallas_v10b)[name]
    return fn(*(jnp.asarray(a) for a in arrays), K, "l2", qt=QT, gpb=2, bounds="sampled",
              interpret=True, **kw)


def _run_port(name, arrays, kw):
    fn = dict(v8=grouped_scan_v8, v9=grouped_scan_v9, v10=grouped_scan_v10,
              v11=grouped_scan_v11, v10b=grouped_scan_v10b)[name]
    return fn(*(torch.from_numpy(a) for a in arrays), K, "l2", qt=QT, gpb=2, bounds="sampled",
              **kw)


@pytest.mark.parametrize("name", ["v8", "v9", "v10", "v11", "v10b"])
@pytest.mark.parametrize("seed,partial", [(13, False), (17, True)])
def test_sampled_scans_match_jax(name, seed, partial):
    """Each wrapper that takes bounds, on its plain version, against the JAX
    function in interpret mode and the exact scan."""
    arrays = _store(seed, partial=partial)
    codes, ids, _, _, q, pids = arrays
    kw = dict(pair_budget=int(pids.size)) if name == "v10b" else {}
    s_t, i_t, _ = _run_port(name, arrays, kw)
    s_j, i_j, _ = _run_jax(name, arrays, kw)
    s_x, i_x, _ = grouped_scan_xla(*(jnp.asarray(a) for a in (codes, ids, q, pids)), K, "l2",
                                   qt=QT, group_chunk=4)
    i_t, s_t = i_t.numpy(), s_t.numpy()
    for a, b, x in zip(i_t, np.asarray(i_j), np.asarray(i_x)):
        assert len(set(a.tolist()) & set(b.tolist())) >= K - 1
        assert len(set(a.tolist()) & set(x.tolist())) >= K - 1
    for a, sa, b, sb in zip(i_t, s_t, np.asarray(i_x), np.asarray(s_x)):
        exact = dict(zip(b.tolist(), sb.tolist()))
        for i, s in zip(a.tolist(), sa.tolist()):
            if i >= 0 and i in exact:
                np.testing.assert_allclose(s, exact[i], rtol=1e-4, atol=1e-4)


def test_clamped_lane_stays_a_candidate():
    """Keys below the scale's floor clamp to 0: the lane is still a
    candidate (packed value key * slot_mult + lane = its lane), unlike a
    lane past the partition's size (-1)."""
    C, D, qt = 128, 8, 8
    codes = torch.zeros((1, C, D))
    normsT = torch.full((1, C), 5.0)  # every key floor(0 - 5) < 0
    slot_mult, levels = packed_params(C)
    out = grouped_scan_plain(torch.zeros(1, dtype=torch.int32), torch.tensor([100], dtype=torch.int32),
                             torch.zeros((1, qt, D)), codes, normsT, 4, slot_mult, levels)
    got = out[0].numpy()
    assert (got >= 0).all() and (got < 100).all()  # keys 0, lanes below the size
    np.testing.assert_array_equal(got[0], np.sort(got[0])[::-1])
