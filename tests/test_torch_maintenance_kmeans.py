"""Maintenance's clustering in the port against quake_tpu.kmeans, on the CPU.

batched_two_means and batched_refine are batched tensor programs in both
packages (jax.jit there, torch here) over the same gathered slabs, with the
same distance forms (the broadcast sum of squared differences in the 2-means,
c_sq - 2 x.c in the refinement), so the assignments are held equal and the
centroids within 1e-5 (f32 sums in another order); the slabs, ids and sizes
they gather are equal. lloyd_refine_np is the same numpy code in both:
equal. The inputs: seeded slabs with -1 row pads, rows of every fill, an
empty partition in the refinement's neighbourhood, l2 and ip. A bf16 store's
split, on the device path in both packages, rounds what it writes as the
rest of the port does: the stores agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import kmeans as jk
from quake_tpu_torch import kmeans as tk
from test_torch_precision import _bits, carry


def _store(P=12, C=256, D=8, seed=0, empty=(3,), metric="l2"):
    """Slabs of clustered points: row r holds sizes[r] valid vectors (two
    blobs each, so the 2-means has something to find), zeros and -1 ids
    past the size; the rows in `empty` hold none."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, C + 1, P).astype(np.int32)
    sizes[list(empty)] = 0
    sizes[0] = C  # a full row
    codes = np.zeros((P, C, D), np.float32)
    ids = np.full((P, C), -1, np.int32)
    nxt = 0
    for r in range(P):
        s = int(sizes[r])
        centers = rng.standard_normal((2, D)).astype(np.float32) * 3
        codes[r, :s] = centers[rng.integers(0, 2, s)] + rng.standard_normal((s, D))
        ids[r, :s] = np.arange(nxt, nxt + s)
        nxt += s
    if metric == "ip":
        codes /= np.maximum(np.linalg.norm(codes, axis=2, keepdims=True), 1e-12)
    cents = np.stack([codes[r, :max(int(sizes[r]), 1)].mean(0) for r in range(P)])
    cents[list(empty)] = rng.standard_normal((len(empty), D))
    return codes, ids, sizes, cents.astype(np.float32)


def _rows_p(rows, bucket):
    out = np.full(bucket, -1, np.int32)
    out[:len(rows)] = rows
    return out


def _compare(got, want):
    """(slabs, slab_ids, sizes, cents, assign) of both packages."""
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=str(i))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("rows,bucket", [([0, 5, 7], 4), ([2, 3, 11, 6, 1], 8), ([9], 1)])
def test_batched_two_means_matches_jax(metric, rows, bucket):
    """Row 3 is empty where it is asked for (its halves stay the zero
    vector, every lane -1); the pads gather nothing."""
    codes, ids, sizes, _ = _store(metric=metric, seed=len(rows))
    rp = _rows_p(rows, bucket)
    want = jk.batched_two_means(jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(sizes),
                                jnp.asarray(rp), niter=5, metric=metric)
    got = tk.batched_two_means(torch.from_numpy(codes), torch.from_numpy(ids),
                               torch.from_numpy(sizes), torch.from_numpy(rp), niter=5,
                               metric=metric)
    _compare(got, want)
    a = got[4].numpy()
    for i, r in enumerate(rows):
        s = int(sizes[r])
        assert (a[i, s:] == -1).all() and set(np.unique(a[i, :s])) <= {0, 1}
        if s >= 20:
            assert len(np.unique(a[i, :s])) == 2  # both halves hold points
    assert (a[len(rows):] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("niter", [1, 3])
def test_batched_refine_matches_jax(metric, niter):
    """A neighbourhood holding the empty row 3 (it keeps its stored
    centroid unless vectors move to it), padded to 8."""
    codes, ids, sizes, cents = _store(metric=metric, seed=7 + niter)
    rp = _rows_p([1, 3, 4, 8, 10], 8)
    want = jk.batched_refine(jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(sizes),
                             jnp.asarray(cents), jnp.asarray(rp), niter=niter, metric=metric)
    got = tk.batched_refine(torch.from_numpy(codes), torch.from_numpy(ids),
                            torch.from_numpy(sizes), torch.from_numpy(cents),
                            torch.from_numpy(rp), niter=niter, metric=metric)
    _compare(got, want)
    assert (got[4].numpy()[5:] == -1).all()
    assert int((got[4].numpy() >= 0).sum()) == int(sizes[[1, 3, 4, 8, 10]].sum())


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_lloyd_refine_np_matches_jax(metric):
    codes, ids, sizes, cents = _store(metric=metric, seed=5)
    rows = [1, 3, 4, 8]
    vecs = [codes[r, :sizes[r]] for r in rows]
    vids = [ids[r, :sizes[r]].astype(np.int64) for r in rows]
    c_t, cl_t = tk.lloyd_refine_np(vecs, vids, cents[rows], metric, 3)
    c_j, cl_j = jk.lloyd_refine_np(vecs, vids, cents[rows], metric, 3)
    np.testing.assert_array_equal(c_t, c_j)
    for (vt, it), (vj, ij) in zip(cl_t, cl_j):
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it, ij)
    empty_c, empty_cl = tk.lloyd_refine_np([], [], cents[:2], metric)
    np.testing.assert_array_equal(empty_c, cents[:2])
    assert all(len(i) == 0 for _, i in empty_cl)


def test_bf16_split_rounds_as_jax():
    """split_partitions on a bf16 store, the batched device path in both
    packages: the halves' codes are the store's own bf16 values (gathered
    as f32, written back through the store's rounding), bit for bit equal
    to the JAX package's, centroids within 1e-5."""
    x = np.random.default_rng(2).standard_normal((3000, 16)).astype(np.float32)
    j = JaxIndex()
    j.build(x, np.arange(3000), JaxBuildParams(nlist=8, precision="bf16", calibrate_aps=False))
    t = carry(j)
    rows = [int(r) for r in t.store.active_rows()[[1, 4, 6]]]
    got, want = t.split_partitions(rows), j.split_partitions(rows)
    assert got == want and t.nlist() == j.nlist() == 11
    st, js = t.store.state, j.store.state
    assert st.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(st.codes), _bits(js.codes))
    for f in ("ids", "sizes", "active"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)))
    np.testing.assert_allclose(st.norms.numpy(), np.asarray(js.norms), rtol=1e-6, atol=0)
    np.testing.assert_allclose(st.centroids.numpy(), np.asarray(js.centroids), rtol=1e-5,
                               atol=1e-5)
    assert t.store.free_rows == j.store.free_rows and t.validate()
