"""exact_distances=False (dequantized scores) in the port against the JAX
package, on the CPU.

With exact=False the v10 and v11 scans skip the exact rescore: a winner's
score is rebuilt from its global-scale key, (key + 0.5) / ginv + gmin (minus
|q|^2 for l2), and no vector is gathered (pallas_grouped.py::_pool_tail and
_rescore_topk). Mirrors tests/test_pallas_grouped.py::
test_v10_dequantized_scores for v10 and v11, l2 and ip: the same id set a
row as the exact mode (pool_factor 1 fixes membership before the rescore),
scores within one quantization step (grange / levels) of the exact scores
and of the JAX package's exact=False scores on the same inputs (its Pallas
kernel in interpret mode; the ids by row overlap >= 0.99: keys in another
order of summation may move a near-tie). One case takes the general branch
of the tail (a pool of 160 > 128 columns at C = 128, where K2's packing no
longer fits 24 bits), and one runs end to end through
QuakeIndex.search(exact_distances=False) on f32 and bf16 stores carried
from the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu.ops.pallas_grouped import grouped_scan_pallas_v10, grouped_scan_pallas_v11
from quake_tpu.ops.scan import scores_to_distances as jax_scores_to_distances
from quake_tpu_torch import SearchParams, index_from_numpy
from quake_tpu_torch.convert import FIELDS
from quake_tpu_torch.ops.grouped_scan import (global_bounds, grouped_scan_v10, grouped_scan_v11,
                                              packed_params, pool_lane_mult)

SCANS = {"v10": (grouped_scan_v10, grouped_scan_pallas_v10),
         "v11": (grouped_scan_v11, grouped_scan_pallas_v11)}


def _inputs(P, C, D, B, nprobe, seed):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((P, C, D)).astype(np.float32)
    ids = np.arange(P * C, dtype=np.int32).reshape(P, C)
    sizes = np.full(P, C, np.int32)
    norms = (codes ** 2).sum(axis=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    pids = np.stack([rng.permutation(P)[:nprobe] for _ in range(B)]).astype(np.int32)
    return codes, ids, sizes, norms, q, pids


def _step(q, norms, metric: str, C: int) -> float:
    """One quantization step of the global scale: grange / levels."""
    _, grange = global_bounds(torch.from_numpy(q), torch.from_numpy(norms), metric)
    return float(grange) / packed_params(C)[1]


def _within(ids_a, s_a, ids_b, s_b, step):
    """Every id of a that b also has: scores within one step."""
    worst = 0.0
    for ia, sa, ib, sb in zip(ids_a, s_a, ids_b, s_b):
        theirs = {int(i): s for i, s in zip(ib, sb) if i >= 0}
        for i, s in zip(ia, sa):
            if i >= 0 and int(i) in theirs:
                worst = max(worst, abs(s - theirs[int(i)]))
    assert worst <= step, (worst, step)


def _overlap(a, b, k):
    return np.mean([len(set(u) & set(v)) / k for u, v in zip(a, b)])


@pytest.mark.parametrize("variant", ["v10", "v11"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [
    # test_v10_dequantized_scores' shape: the pool (20 columns) goes through K2.
    (8, 256, 16, 16, 4, 5, 8),
    # C = 128, pool 16 x 10 = 160 > 128: levels * 256 + 256 >= 2^24, the
    # general branch (a top-k of the keys).
    (24, 128, 16, 32, 16, 10, 8),
])
def test_dequantized_scores(shape, metric, variant):
    P, C, D, B, nprobe, k, qt = shape
    codes, ids, sizes, norms, q, pids = _inputs(P, C, D, B, nprobe, 31)
    slot_mult, levels = packed_params(C)
    general = levels * pool_lane_mult(nprobe * k) + pool_lane_mult(nprobe * k) >= 1 << 24
    assert general == (C == 128)
    port, jax_fn = SCANS[variant]
    targs = tuple(torch.from_numpy(a) for a in (codes, ids, sizes, norms, q, pids))
    s1, i1, _ = port(*targs, k, metric, qt=qt, gpb=2, exact=True)
    s2, i2, n2 = port(*targs, k, metric, qt=qt, gpb=2, exact=False)
    s1, i1, s2, i2 = s1.numpy(), i1.numpy(), s2.numpy(), i2.numpy()
    assert s2.shape == (B, k) and i2.dtype == np.int32 and (n2.numpy() == nprobe).all()
    for b in range(B):
        assert set(i1[b].tolist()) == set(i2[b].tolist()), b
    step = _step(q, norms, metric, C)
    _within(i1, s1, i2, s2, step)

    jargs = tuple(jnp.asarray(a) for a in (codes, ids, sizes, norms, q, pids))
    s3, i3, _ = jax_fn(*jargs, k, metric, qt=qt, gpb=2, interpret=True, exact=False)
    s3, i3 = np.asarray(s3), np.asarray(i3)
    assert _overlap(i2, i3, k) >= 0.99
    _within(i2, s2, i3, s3, step)


@pytest.fixture(scope="module")
def jax_pair():
    """The same JAX-built data at both precisions: 6,000 x 32, 16 partitions."""
    x = np.random.default_rng(41).standard_normal((6000, 32)).astype(np.float32)
    out = {}
    for prec in ("f32", "bf16"):
        idx = JaxIndex()
        idx.build(x, np.arange(len(x)), JaxBuildParams(nlist=16, niter=5, precision=prec,
                                                       calibrate_aps=False))
        out[prec] = idx
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_search_end_to_end(jax_pair, monkeypatch, precision):
    """QuakeIndex.search(exact_distances=False) on a carried store against
    the JAX package's stages (the Pallas parent ranking and the v11 scan
    with exact=False, interpret mode) on the same store: row overlap >=
    0.99, distances of the common ids within one step (in squared l2, the
    scores' unit); and against the port's exact search: the same id set a
    row, the scores within one step (bf16: plus the query's rounding, which
    the keys see and the exact rescore does not)."""
    monkeypatch.setenv("QUAKE_TPU_PARENT_KERNEL", "pallas")
    jidx = jax_pair[precision]
    arrays = lambda st: {f: np.asarray(getattr(st, f)) for f in FIELDS}
    tidx = index_from_numpy(arrays(jidx.store.state), arrays(jidx.parent.store.state), "l2",
                            device="cpu")
    assert tidx.store.state.codes.dtype == (torch.bfloat16 if precision == "bf16"
                                            else torch.float32)
    q = np.random.default_rng(43).standard_normal((48, 32)).astype(np.float32)
    k, nprobe = 10, 4
    res = tidx.search(q, SearchParams(k=k, nprobe=nprobe, exact_distances=False))
    exact = tidx.search(q, SearchParams(k=k, nprobe=nprobe))
    for a, b in zip(res.ids, exact.ids):
        assert set(a.tolist()) == set(b.tolist())

    st, pst = jidx.store.state, jidx.parent.store.state
    qj = jnp.asarray(q)
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, qj, nprobe, "l2", interpret=True)
    pids = jnp.where(pids >= 0, pids, pids[:, :1])
    gpb = int(tidx._grouped_kernel()[len("v11g"):])
    s_j, i_j, _ = grouped_scan_pallas_v11(st.codes, st.ids, st.sizes, st.norms, qj, pids, k,
                                          "l2", qt=tidx._grouped_params(len(q), nprobe)[0],
                                          gpb=gpb, interpret=True, exact=False)
    d_j = np.asarray(jax_scores_to_distances(s_j, i_j, "l2"))
    i_j = np.asarray(i_j)
    assert _overlap(res.ids, i_j, k) >= 0.99
    norms = tidx.store.state.norms.numpy()
    step = _step(q, norms, "l2", tidx.store.C)
    _within(res.ids, -res.distances ** 2, i_j, -d_j ** 2, step)
    # The exact rescore multiplies the f32 query; the keys were taken on the
    # query rounded to bf16, which moves 2 <q, x> by up to 2^-8 |q| |x|.
    rounding = 0.0
    if precision == "bf16":
        rounding = 2.0 ** -8 * float(np.sqrt((q * q).sum(1).max() * norms.max()))
    _within(res.ids, -res.distances ** 2, exact.ids, -exact.distances ** 2, step + rounding)
