"""quake_tpu_torch store, build helpers and copied modules against the JAX
package on the same inputs (CPU).

Store arrays are placed by integer arithmetic and must be equal; the cached
norms are f32 sums whose order of summation differs between the packages,
so they compare with rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quake_tpu.kmeans as jkm
import quake_tpu.params as jparams
from quake_tpu.geometry import effective_dimension as jax_effective_dimension
from quake_tpu.storage.store import PartitionStore as JaxStore
from quake_tpu_torch import kmeans as tkm
from quake_tpu_torch import params as tparams
from quake_tpu_torch.convert import index_from_numpy, store_from_numpy
from quake_tpu_torch.geometry import effective_dimension
from quake_tpu_torch.storage.idmap import make_id_map
from quake_tpu_torch.storage.store import PartitionStore
from quake_tpu_torch.utils import compute_recall, knn, next_pow2

FIELDS = ("codes", "ids", "sizes", "centroids", "active", "norms")


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _assert_same_store(jax_state, port_state):
    for f in FIELDS:
        want = np.asarray(getattr(jax_state, f))
        got = getattr(port_state, f).cpu().numpy()
        assert got.shape == want.shape, f
        if f == "norms":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)


@pytest.mark.parametrize("n,d,nlist,seed", [(3000, 8, 12, 0), (5000, 16, 200, 1)])
def test_init_from_assignments_matches_jax(n, d, nlist, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    assign = rng.integers(0, nlist, n)
    assign[:400] = 0  # one large partition sets C
    js = JaxStore(d)
    js.init_from_assignments(x, ids, cents, assign.astype(np.int32))
    ts = PartitionStore(d, "cpu")
    ts.init_from_assignments(x, ids, cents, assign)
    assert (ts.P, ts.C, ts.nlist(), ts.ntotal()) == (js.P, js.C, js.nlist(), js.ntotal())
    assert ts.free_rows == js.free_rows
    _assert_same_store(js.state, ts.state)
    rows = ts.id_map.get_batch(ids[:50])
    np.testing.assert_array_equal(rows, assign[:50])


def test_init_single_partition_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    ids = np.arange(300)
    js = JaxStore(8)
    js.init_single_partition(x, ids)
    ts = PartitionStore(8, "cpu")
    ts.init_single_partition(x, ids)
    assert (ts.P, ts.C) == (1, 384) == (js.P, js.C)
    _assert_same_store(js.state, ts.state)


def test_store_from_numpy_round_trip():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    js = JaxStore(8)
    js.init_from_assignments(x, np.arange(1000), rng.standard_normal((5, 8)),
                             rng.integers(0, 5, 1000).astype(np.int32))
    ts = store_from_numpy(_jax_arrays(js.state), "cpu")
    _assert_same_store(js.state, ts.state)
    assert ts.free_rows == js.free_rows and ts.ntotal() == 1000
    with pytest.raises(ValueError, match="missing"):
        store_from_numpy({"codes": np.zeros((1, 1, 1))}, "cpu")
    idx = index_from_numpy(_jax_arrays(js.state), _jax_arrays(js.state), "ip", device="cpu")
    assert idx.metric == "ip" and idx.parent.metric == "ip" and idx.nlist() == 5


def test_balance_clusters_and_kmeans_np_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4000, 8)).astype(np.float32)
    cents = rng.standard_normal((4, 8)).astype(np.float32)
    assign = rng.integers(0, 4, 4000)
    assign[:2500] = 1  # oversized
    jc, ja = jkm.balance_clusters(x, cents, assign, cap=1024)
    tc, ta = tkm.balance_clusters(x, cents, assign, cap=1024)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jc, tc)
    assert np.bincount(ta).max() <= 1024
    jc2, _ = jkm.kmeans_np(x[:500], np.arange(500), 3, metric="ip")
    tc2, _ = tkm.kmeans_np(x[:500], np.arange(500), 3, metric="ip")
    np.testing.assert_array_equal(jc2, tc2)


def test_effective_dimension_matches_jax():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2000, 4)).astype(np.float32)
    x = z @ rng.standard_normal((4, 32)).astype(np.float32)
    assert effective_dimension(x) == jax_effective_dimension(x)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["IndexBuildParams", "SearchParams",
                                  "MaintenancePolicyParams"])
def test_params_defaults_match_jax(name):
    assert _fields(getattr(tparams, name)) == _fields(getattr(jparams, name))


def test_utils_and_idmap_copies():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    ids, dist = knn(q, x, 4)
    assert compute_recall(ids, ids, 4) == 1.0
    assert next_pow2(33) == 64 and next_pow2(3, floor=8) == 8
    np.testing.assert_allclose(dist[:, 0], np.sqrt(((x[ids[:, 0]] - q) ** 2).sum(1)),
                               rtol=1e-5)
    m = make_id_map()
    assert m.set_batch(np.array([5, 7]), np.array([1, 2])) == 2
    assert m.get_batch(np.array([7, 9])).tolist() == [2, -1]
    assert m.erase_batch(np.array([5])) == 1 and len(m) == 1


def test_store_tensors_on_requested_device():
    ts = PartitionStore(4, "cpu")
    ts.init_from_assignments(np.ones((10, 4)), np.arange(10), np.ones((2, 4)),
                             np.array([0, 1] * 5))
    st = ts.state
    assert st.codes.device == torch.device("cpu")
    assert (st.codes.dtype, st.ids.dtype, st.sizes.dtype, st.norms.dtype, st.active.dtype) == (
        torch.float32, torch.int32, torch.int32, torch.float32, torch.bool)
    assert int(st.sizes.sum()) == 10
