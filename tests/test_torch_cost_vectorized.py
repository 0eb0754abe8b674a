"""Maintenance's cost model as one array pass, against the JAX package's
scalar one, on the CPU.

What is held, and how closely:
  * ListScanLatencyEstimator.estimate_scan_latency_array equal to the bit
    (np.array_equal) to the JAX package's scalar estimate_scan_latency, at
    n below the grid, on its points, between them, off the integers and
    beyond its end (extrapolation), at k = 10 and on the k points, and on an
    (n, k) mesh; the port's scalar form is one point of the array form, so
    the JAX package is the independent side;
  * compute_split_delta_array, compute_delete_delta_array and
    compute_delete_delta_w_reassign equal to the bit to the JAX package's
    scalar deltas on seeded sizes and hit rates that take both branches of
    the delete delta (size below the partition count, and the merged size's
    ceiling) and sizes beyond the grid's end;
  * PartitionStore.active_rows: the rows not free, ascending, int64.
Both packages read one grid from one CSV: the analytic grid, and the
packaged H100 grid at d = 128 (quake_tpu_torch/data), each saved by the port.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from quake_tpu.maintenance.cost_estimator import MaintenanceCostEstimator as JaxCost
from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator as JaxLatency
from quake_tpu_torch.maintenance.cost_estimator import MaintenanceCostEstimator
from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator
from quake_tpu_torch.storage.store import PartitionStore

D, ALPHA, K = 128, 0.9, 10
GRIDS = ["analytic", "h100_d128"]


@pytest.fixture(scope="module", params=GRIDS)
def grids(request, tmp_path_factory):
    """(port estimator, JAX estimator) on one grid read from one CSV."""
    est = ListScanLatencyEstimator(D, packaged=request.param != "analytic")
    assert est.grid_source == ("analytic" if request.param == "analytic"
                               else "packaged(d=128,scale=1.000)")
    path = str(tmp_path_factory.mktemp("grid") / f"{request.param}.csv")
    est.save(path)
    t, j = ListScanLatencyEstimator.from_csv(path), JaxLatency.from_csv(path)
    assert t.grid_source == j.grid_source == "csv"
    np.testing.assert_array_equal(t.latency_grid, j.latency_grid)
    return t, j


def _n_points(kind: str, nv: list) -> np.ndarray:
    mids = [(a + b) / 2.0 for a, b in zip(nv, nv[1:])]
    return np.asarray({
        "below": [0.0, 0.25, 0.5, 0.999, -3.0],
        "on_grid": [float(v) for v in nv],
        "between": mids + [a + 1.0 for a in nv[:-1]] + [b - 1.0 for b in nv[2:]],
        "non_integer": [1.5, 3.7, 17.25, 999.999, 4096.5, 12345.678, 65535.9],
        "beyond": [65536.5, 65537.0, 70000.0, 131072.0, 1e6, 12345678.9],
    }[kind], dtype=np.float64)


@pytest.mark.parametrize("k", ["10", "grid"])
@pytest.mark.parametrize("kind", ["below", "on_grid", "between", "non_integer", "beyond"])
def test_lookup_equals_jax_scalar(grids, kind, k):
    t, j = grids
    ns = _n_points(kind, t.n_values)
    for kk in ([10.0] if k == "10" else [float(v) for v in t.k_values]):
        want = np.array([j.estimate_scan_latency(float(n), kk) for n in ns])
        got = t.estimate_scan_latency_array(ns, kk)
        assert got.dtype == np.float64 and got.shape == ns.shape
        assert np.array_equal(got, want), (kind, kk)
        assert [t.estimate_scan_latency(float(n), kk) for n in ns] == want.tolist()


def test_lookup_mesh_equals_jax_scalar(grids):
    """n and k both arrays, broadcast to a mesh (the way the packaged grid
    is carried onto an estimator's points)."""
    t, j = grids
    ns = np.concatenate([_n_points(kind, t.n_values) for kind in ("below", "between", "beyond")])
    ks = np.asarray([0.5, 1.0, 3.0, 10.0, 64.0, 100.5, 256.0, 300.0])
    want = np.array([[j.estimate_scan_latency(float(n), float(k)) for k in ks] for n in ns])
    assert np.array_equal(t.estimate_scan_latency_array(ns[:, None], ks[None, :]), want)


def _round(seed: int, total: int):
    """Seeded sizes and hit rates of `total` partitions: a third below the
    partition count (the delete delta's first branch), the rest at or above
    it, some beyond the grid's last n; hit rates with zeros, a window's
    fractions and a few hot rows."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, total, total // 3)
    big = rng.integers(total, 60000, total - total // 3 - 4)
    huge = rng.integers(65537, 400000, 4)
    small[0], big[0] = total - 1, total  # either side of the delete delta's branch
    sizes = rng.permutation(np.concatenate([small, big, huge])).astype(np.int64)
    hits = rng.poisson(14 * 1000 / total, total).astype(np.int64)
    hits[rng.integers(0, total, 3)] = 0
    hits[rng.integers(0, total, 2)] = 900
    return sizes, hits / 1000


SEEDS = [0, 1, 2, 3, 2**31 + 11]
TOTALS = [160, 17]


@pytest.mark.parametrize("total", TOTALS)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_delta_equals_jax(grids, seed, total):
    t, j = grids
    sizes, hr = _round(seed, total)
    tc, jc = MaintenanceCostEstimator(D, ALPHA, K, t), JaxCost(D, ALPHA, K, j)
    want = np.array([jc.compute_split_delta(int(s), float(h), total) for s, h in zip(sizes, hr)])
    assert np.array_equal(tc.compute_split_delta_array(sizes, hr, total), want)
    assert tc.compute_split_delta(int(sizes[0]), float(hr[0]), total) == want[0]


@pytest.mark.parametrize("total", TOTALS)
@pytest.mark.parametrize("seed", SEEDS)
def test_delete_delta_equals_jax(grids, seed, total):
    t, j = grids
    sizes, hr = _round(seed, total)
    avg_size, avg_hr = float(sizes.sum()) / total, 14 / total
    # Both branches, sizes beyond the grid's end, and at 17 partitions
    # merged sizes whose ceiling lies beyond it too.
    assert (sizes < total).any() and (sizes >= total).any()
    assert (sizes > t.n_values[-1]).any()
    beyond = [math.ceil(avg_size + s / (total - 1)) > t.n_values[-1]
              for s in sizes if s >= total]
    assert any(beyond) == (total == 17)
    tc, jc = MaintenanceCostEstimator(D, ALPHA, K, t), JaxCost(D, ALPHA, K, j)
    want = np.array([jc.compute_delete_delta(int(s), float(h), total, avg_hr, avg_size)
                     for s, h in zip(sizes, hr)])
    assert np.array_equal(tc.compute_delete_delta_array(sizes, hr, total, avg_hr, avg_size), want)
    assert tc.compute_delete_delta(int(sizes[0]), float(hr[0]), total, avg_hr,
                                   avg_size) == want[0]


@pytest.mark.parametrize("total", [1, 0])
def test_delete_delta_one_partition(grids, total):
    """At most one partition: every delete delta is 0, as the JAX package's."""
    t, j = grids
    tc, jc = MaintenanceCostEstimator(D, ALPHA, K, t), JaxCost(D, ALPHA, K, j)
    got = tc.compute_delete_delta_array(np.array([0, 5, 900]), np.array([0.0, 0.1, 0.5]),
                                        total, 0.1, 300.0)
    assert got.tolist() == [jc.compute_delete_delta(5, 0.1, total, 0.1, 300.0)] * 3 == [0.0] * 3


@pytest.mark.parametrize("width", [0, 1, 2, 9])
@pytest.mark.parametrize("seed", SEEDS)
def test_delete_delta_w_reassign_equals_jax(grids, seed, width):
    """The reassigned partitions' terms, summed in the JAX loop's order."""
    t, j = grids
    sizes, hr = _round(seed, 160)
    tc, jc = MaintenanceCostEstimator(D, ALPHA, K, t), JaxCost(D, ALPHA, K, j)
    for r in range(0, 160, 23):
        rs, rh = sizes[r + 1:r + 1 + width], hr[r + 1:r + 1 + width]
        counts = [1] * len(rs)
        want = jc.compute_delete_delta_w_reassign(int(sizes[r]), hr[r], 160, counts,
                                                  rs.tolist(), rh.tolist())
        got = tc.compute_delete_delta_w_reassign(int(sizes[r]), hr[r], 160, counts, rs, rh)
        assert isinstance(got, float) and got == want


@pytest.mark.parametrize("free", [[], [7, 3], [0, 9], list(range(10))[::-1]])
def test_active_rows_mask(free):
    store = SimpleNamespace(P=10, free_rows=list(free))
    rows = PartitionStore.active_rows(store)
    assert rows.dtype == np.int64
    assert rows.tolist() == [r for r in range(10) if r not in set(free)]
