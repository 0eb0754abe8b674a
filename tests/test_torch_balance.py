"""The build's balancing (kmeans.balance_clusters) against the JAX
package's, on the CPU.

- l2: the port gathers each round's members from one stable argsort of the
  assignments, where the JAX package scans the assignments once a cluster;
  the centroids and assignments are equal bit for bit, over rounds that
  split many clusters, some of them again.
- ip (a deliberate deviation, ROADMAP.md Queue 3): the port splits at the
  build's metric, so every split centroid of an ip build is unit-norm, as
  the reference's k-means normalizes for IP (clustering.cpp:25-26); the JAX
  package splits at l2, whose means of unit vectors are shorter than 1.
"""

import numpy as np
import pytest

import quake_tpu.kmeans as jkm
from quake_tpu_torch import IndexBuildParams, QuakeIndex
from quake_tpu_torch import kmeans as tkm


def _skewed(n: int, d: int, nlist: int, seed: int, unit: bool = False):
    """Points of `nlist` Gaussian blobs of very unequal sizes, the blobs'
    means as centroids and each point's blob as its assignment."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    weight = rng.uniform(0.1, 1.0, nlist) ** 2
    assign = rng.choice(nlist, n, p=weight / weight.sum())
    x = (means[assign] + rng.standard_normal((n, d))).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        means /= np.linalg.norm(means, axis=1, keepdims=True)
    return x, means, assign


@pytest.mark.parametrize("seed", [0, 1])
def test_l2_balance_equals_jax_bit_for_bit(seed):
    x, cents, assign = _skewed(30000, 12, 24, seed)
    cap = 512
    jc, ja = jkm.balance_clusters(x, cents, assign, cap=cap)
    tc, ta = tkm.balance_clusters(x, cents, assign, cap=cap)
    assert int((np.bincount(assign) > cap).sum()) >= 5  # many oversized clusters
    assert tc.shape[0] >= cents.shape[0] + 20  # split over several rounds
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype and ta.dtype == ja.dtype
    assert np.bincount(ta).max() <= cap


def test_ip_split_centroids_are_unit_norm_where_jax_are_not():
    x, cents, assign = _skewed(20000, 16, 16, 3, unit=True)
    cap = 640
    tc, ta = tkm.balance_clusters(x, cents, assign, cap=cap, metric="ip")
    jc, _ = jkm.balance_clusters(x, cents, assign, cap=cap)
    split = tc.shape[0] - cents.shape[0]
    assert split >= 5 and jc.shape[0] - cents.shape[0] >= 5
    np.testing.assert_allclose(np.linalg.norm(tc, axis=1), 1.0, atol=1e-5)
    assert np.linalg.norm(jc, axis=1).min() < 0.99  # the JAX package's l2 means
    assert np.bincount(ta).max() <= cap
    # The metric changes the splits alone: at l2 the port is the JAX package.
    lc, la = tkm.balance_clusters(x, cents, assign, cap=cap, metric="l2")
    np.testing.assert_array_equal(lc, jc)


def test_ip_build_keeps_every_centroid_unit_norm():
    """An ip build whose balancing splits: every centroid the index holds,
    the split ones among them, lies on the unit sphere."""
    x, _, _ = _skewed(12000, 16, 8, 5, unit=True)
    idx = QuakeIndex(device="cpu")
    t = idx.build(x, None, IndexBuildParams(metric="ip", nlist=16, niter=4, balance_factor=1.1,
                                            calibrate_aps=False))
    assert idx.nlist() > 16 and t.n_clusters == idx.nlist()
    norms = np.linalg.norm(idx.centroids(), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert t.balance_time_us > 0 and t.calibrate_time_us == 0
