"""QuakeIndex.save / load across the two packages, on the CPU.

Both write the JAX package's directory format (metadata.json, codes, ids,
sizes, centroids, active and generation as .npy, a recursive parent/), so
each loads what the other saved. A load is held to the carry of the same
index through `index_from_numpy` with its host bookkeeping (free rows,
generations): equal arrays (the norms are recomputed from the codes on load:
rtol 1e-6), equal bookkeeping and id map, equal search ids. The APS
calibration is kept; the latency grid (latency_profile.csv) is parsed into
the loaded index's fresh maintenance policy, and a grid profiled by either
package crosses to the other with its values and bytes. bf16 checkpoints:
tests/test_torch_precision.py; spilled ones: tests/test_torch_spill.py.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
from test_torch_index_mutation import _data, assert_same_index, carry
from test_torch_store_mutation import _assert_same, _contract_6, _id_map

N0, D = 4000, 16


@pytest.fixture(scope="module")
def mutated_jax(tmp_path_factory):
    """A JAX index after adds, removes and a flood that splits a partition
    (free rows out of order, generations moved on), with APS calibration
    fields and a latency profile set, saved."""
    idx = JaxIndex()
    idx.build(_data(N0, 11), np.arange(N0), JaxBuildParams(nlist=12, niter=5, calibrate_aps=False))
    x = _data(1500, 12)
    idx.add(x[:1000], np.arange(10_000, 11_000))
    idx.remove(np.arange(0, 400))
    C = idx.store.C
    flood = x[1000] + 0.001 * np.random.default_rng(13).standard_normal((int(2.5 * C), D))
    idx.add(flood.astype(np.float32), np.arange(50_000, 50_000 + len(flood)))
    idx.remove(np.arange(10_000, 10_100))
    assert idx.nlist() > 12 and idx.validate()
    idx.aps_gamma, idx.aps_dense_w, idx.aps_calib_target = 1.25, 7, 0.9
    idx.aps_radius_ab = np.arange(6, dtype=np.float32).reshape(3, 2)
    idx.latency_profile = ListScanLatencyEstimator(D, n_values=[64, 128], k_values=[1, 10],
                                                   packaged=False)
    path = str(tmp_path_factory.mktemp("jax") / "idx")
    idx.save(path)
    return idx, path


def _queries():
    return _data(48, 14)


def _assert_loaded_equals_carry(loaded, carried):
    """Arrays, bookkeeping and id map of both levels, and search ids."""
    for a, b in ((loaded, carried), (loaded.parent, carried.parent)):
        for f in ("codes", "ids", "sizes", "centroids", "active", "norms"):
            got, want = getattr(a.store.state, f).numpy(), getattr(b.store.state, f).numpy()
            if f == "norms":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)
        assert a.store.free_rows == b.store.free_rows
        np.testing.assert_array_equal(a.store.generation, b.store.generation)
        assert _id_map(a.store.id_map) == _id_map(b.store.id_map)
        assert (a.level, a.metric, a.nlist(), a.ntotal()) == (b.level, b.metric, b.nlist(),
                                                              b.ntotal())
        assert a.validate()
        _contract_6(a.store)
    sp = SearchParams(k=10, nprobe=5)
    np.testing.assert_array_equal(loaded.search(_queries(), sp).ids,
                                  carried.search(_queries(), sp).ids)


def test_port_loads_what_jax_saved(mutated_jax):
    jidx, path = mutated_jax
    loaded = QuakeIndex(device="cpu").load(path)
    _assert_loaded_equals_carry(loaded, carry(jidx))
    assert loaded.build_params.nlist == jidx.nlist() and loaded.build_params.dimension == D
    assert loaded.aps_gamma == 1.25 and loaded.aps_dense_w == 7
    np.testing.assert_array_equal(loaded.aps_radius_ab, jidx.aps_radius_ab)
    est = loaded.latency_profile
    assert est.d == 16 and est.grid_source == "csv"
    assert (est.n_values, est.k_values) == ([64, 128], [1, 10])
    np.testing.assert_allclose(est.latency_grid, jidx.latency_profile.latency_grid, rtol=1e-5)
    assert loaded.maintenance_policy.cost_estimator.latency_estimator is est


def test_jax_loads_what_the_port_saved(mutated_jax, tmp_path):
    """The port saves a carried index; the JAX package loads it and holds
    the same arrays, bookkeeping, APS fields and latency profile as the
    index it came from, and returns that index's search ids."""
    jidx, path = mutated_jax
    out = str(tmp_path / "port")
    QuakeIndex(device="cpu").load(path).save(out)
    back = JaxIndex().load(out)
    assert_same_index(back, carry(jidx))
    for js, ts in ((jidx.store, back.store), (jidx.parent.store, back.parent.store)):
        assert js.free_rows == ts.free_rows
        np.testing.assert_array_equal(js.generation, ts.generation)
    sp = JaxSearchParams(k=10, nprobe=5)
    np.testing.assert_array_equal(back.search(_queries(), sp).ids,
                                  jidx.search(_queries(), sp).ids)
    assert back.aps_gamma == 1.25 and back.aps_calib_target == 0.9
    np.testing.assert_array_equal(back.aps_radius_ab, jidx.aps_radius_ab)
    assert back.latency_profile is not None and back.latency_profile.grid_source == "csv"
    for name in ("metadata.json", "latency_profile.csv"):
        with open(os.path.join(path, name)) as f, open(os.path.join(out, name)) as g:
            want, got = f.read(), g.read()
        assert (json.loads(got) == json.loads(want)) if name.endswith("json") else got == want


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_profiled_grid_crosses_both_ways(tmp_path, saver):
    """A latency grid profiled at build and saved by one package is the
    grid the other package's loaded index and its fresh policy use: the
    same values (%.6g in the CSV), and the same bytes when the loader saves
    it again."""
    x = _data(2000, 16)
    if saver == "jax":
        src = JaxIndex()
        src.build(x, np.arange(2000), JaxBuildParams(nlist=6, calibrate_aps=False))
    else:
        src = QuakeIndex(device="cpu")
        src.build(x, np.arange(2000), IndexBuildParams(nlist=6, calibrate_aps=False))
    est = src.profile_latency(n_values=[64, 256], k_values=[1, 8])
    assert est.grid_source == "profiled"
    first, again = str(tmp_path / "first"), str(tmp_path / "again")
    src.save(first)
    loaded = (QuakeIndex(device="cpu") if saver == "jax" else JaxIndex()).load(first)
    got = loaded.latency_profile
    assert got.grid_source == "csv" and (got.n_values, got.k_values) == ([64, 256], [1, 8])
    np.testing.assert_allclose(got.latency_grid, est.latency_grid, rtol=1e-5)
    assert loaded.maintenance_policy.cost_estimator.latency_estimator is got
    assert loaded.maintenance_policy.hit_count_tracker.get_num_queries_recorded() == 0
    loaded.save(again)
    with open(os.path.join(first, "latency_profile.csv"), "rb") as f, \
            open(os.path.join(again, "latency_profile.csv"), "rb") as g:
        assert f.read() == g.read()


def test_allocate_rows_agrees_after_load(mutated_jax):
    """The loaded free-row order is the JAX package's: both take the same
    rows, and the generations move on alike."""
    _, path = mutated_jax
    jl, tl = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    assert tl.store.allocate_rows(3) == jl.store.allocate_rows(3)
    np.testing.assert_array_equal(tl.store.generation, jl.store.generation)
    assert tl.store.free_rows == jl.store.free_rows


def test_loaded_index_mutates_like_jax(mutated_jax):
    """Loaded in both packages, the same flood and removal leave the same
    stores."""
    _, path = mutated_jax
    jl, tl = JaxIndex().load(path), QuakeIndex(device="cpu").load(path)
    assert_same_index(jl, tl)
    x = _data(1200, 15)
    for index in (jl, tl):
        index.add(x, np.arange(70_000, 71_200))
        index.remove(np.arange(70_000, 70_300))
    assert_same_index(jl, tl)
    _assert_same(jl.store, tl.store)


def _edit_metadata(src, dst, **changes):
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "metadata.json")) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(os.path.join(dst, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return dst


@pytest.mark.parametrize("changes,match", [
    # Lifted: a checkpoint marked bf16 loads (the case keeps the id it had as
    # a guard).
    pytest.param(dict(precision="bf16"), None, id="changes0-item 5: bf16"),
    # Lifted: a checkpoint marked spilled loads as the JAX package loads it.
    pytest.param(dict(spill=True), None, id="changes1-item 6: spill"),
    (dict(version=2), "serialization version"),
])
def test_load_refuses_by_name(mutated_jax, tmp_path, changes, match):
    """Refused by name; a lifted case loads as the JAX package loads it: f32
    codes under precision "bf16" are rounded to bf16 at load (its
    jnp.asarray(codes, bfloat16)), bit for bit, the norms recomputed from
    the rounded codes (rtol 1e-6), the bookkeeping as saved; a store marked
    spilled whose ids are each resident once has them all in id_map, an
    empty spill_map, and fails validate() in both packages (two residencies
    a vector expected; test_torch_spill.py loads real spilled checkpoints)."""
    _, path = mutated_jax
    bad = _edit_metadata(path, str(tmp_path / "bad"), **changes)
    if changes.get("spill"):
        jl, tl = JaxIndex().load(bad), QuakeIndex(device="cpu").load(bad)
        assert tl.spill and jl.spill and len(tl.store.spill_map) == 0
        _assert_same(jl.store, tl.store)
        assert not tl.validate() and not jl.validate()
        return
    if match is None:
        jl, tl = JaxIndex().load(bad), QuakeIndex(device="cpu").load(bad)
        js, ts = jl.store, tl.store
        assert ts.state.codes.dtype == torch.bfloat16
        np.testing.assert_array_equal(ts.state.codes.view(torch.int16).numpy(),
                                      np.asarray(js.state.codes).view(np.int16))
        np.testing.assert_allclose(ts.state.norms.numpy(), np.asarray(js.state.norms),
                                   rtol=1e-6, atol=0)
        assert ts.free_rows == js.free_rows and tl.validate()
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        QuakeIndex(device="cpu").load(bad)


def test_load_num_workers_builds_plain_on_one_device(mutated_jax):
    """ROADMAP Queue 3 fault 8 at load: n_workers > 1 shards only over as
    many CUDA devices; a CPU index loads plain."""
    _, path = mutated_jax
    tl = QuakeIndex(device="cpu").load(path, n_workers=4)
    assert tl.validate() and tl.ntotal() > 0


def test_save_load_roundtrip(tmp_path):
    """tests/test_index.py's round trip in the port: equal results, and the
    loaded index stays mutable."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2100, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x[:2000], np.arange(2000), IndexBuildParams(nlist=16, calibrate_aps=False))
    res1 = idx.search(q, SearchParams(k=10, nprobe=16))
    idx.save(str(tmp_path / "idx"))
    idx2 = QuakeIndex(device="cpu").load(str(tmp_path / "idx"))
    assert (idx2.ntotal(), idx2.nlist(), idx2.metric) == (idx.ntotal(), idx.nlist(), idx.metric)
    res2 = idx2.search(q, SearchParams(k=10, nprobe=16))
    np.testing.assert_array_equal(res1.ids, res2.ids)
    np.testing.assert_allclose(res1.distances, res2.distances, rtol=1e-5)
    idx2.add(x[2000:2100], np.arange(2000, 2100))
    assert idx2.ntotal() == 2100 and idx2.validate()
    assert idx2.aps_dimension == idx.aps_dimension > 0


def test_flat_index_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    flat = QuakeIndex(device="cpu")
    flat.build(x, None, IndexBuildParams(nlist=0))
    flat.save(str(tmp_path / "flat"))
    back = QuakeIndex(device="cpu").load(str(tmp_path / "flat"))
    assert back.parent is None and back.nlist() == 1 and back.ntotal() == 300
    np.testing.assert_array_equal(back.search(x[:20], SearchParams(k=3)).ids,
                                  flat.search(x[:20], SearchParams(k=3)).ids)
    assert not os.path.exists(str(tmp_path / "flat" / "parent"))
