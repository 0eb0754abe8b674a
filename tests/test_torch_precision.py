"""bf16 codes (IndexBuildParams(precision="bf16")) in the port, on the CPU.

The first four cases mirror tests/test_precision.py in the port: a bf16
build and search, mutation and save/load, recall parity with f32, and a
checkpoint half the size. The rest hold the port to the JAX package on one
bf16 store carried across by `index_from_numpy`:

  * codes bit for bit (int16 views) after the carry, `add`, `remove` and
    `modify`, and after the store's own rounding of the same clustering;
    the cached norms (f32 squared norms of the rounded codes, summed in
    another order) within rtol 1e-6, as in test_torch_store.py;
  * the v11 and v10 scans (the queries rounded to bf16, products exact in
    f32, summed in another order) by row overlap >= 0.99 against the JAX
    package's interpret-mode Pallas run;
  * the query-major and flat searches (plain tensor operations in both
    packages) with equal ids and distances within rtol 1e-5;
  * gpb, which sets the sort-key budget and so the placement, by the JAX
    package's rule with 2 bytes an element;
  * checkpoints: each package loads the other's bf16 save, codes equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quake_tpu.index as jax_index_module
from quake_tpu import IndexBuildParams as JaxBuildParams
from quake_tpu import QuakeIndex as JaxIndex
from quake_tpu import SearchParams as JaxSearchParams
from quake_tpu.ops.pallas_flat import parent_rank_pallas
from quake_tpu.ops.pallas_grouped import grouped_scan_pallas_v10, grouped_scan_pallas_v11
from quake_tpu.storage.store import PartitionStore as JaxStore
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy
from quake_tpu_torch.convert import FIELDS
from quake_tpu_torch.ops.grouped_scan import grouped_scan_v10, grouped_scan_v11
from quake_tpu_torch.storage.store import PartitionStore
from quake_tpu_torch.utils import compute_recall, knn

D = 16


def _data(n, seed, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _bits(codes) -> np.ndarray:
    """int16 view of bf16 codes, from either package."""
    if isinstance(codes, torch.Tensor):
        return codes.view(torch.int16).numpy()
    return np.asarray(codes).view(np.int16)


def assert_same_bf16_store(js, ts):
    """Codes bit for bit, ids, sizes, centroids, active equal, norms within
    rtol 1e-6, and the host bookkeeping equal."""
    assert ts.state.codes.dtype == torch.bfloat16 and js.state.codes.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(ts.state.codes), _bits(js.state.codes))
    for f in ("ids", "sizes", "centroids", "active"):
        np.testing.assert_array_equal(getattr(ts.state, f).numpy(),
                                      np.asarray(getattr(js.state, f)), err_msg=f)
    np.testing.assert_allclose(ts.state.norms.numpy(), np.asarray(js.state.norms),
                               rtol=1e-6, atol=0)
    assert ts.free_rows == js.free_rows
    np.testing.assert_array_equal(ts.generation, js.generation)


def carry(jidx) -> QuakeIndex:
    def arrays(store):
        out = {f: np.asarray(getattr(store.state, f)) for f in FIELDS}
        out.update(free_rows=list(store.free_rows), generation=store.generation.copy(),
                   cap_multiple=store.cap_multiple)
        return out

    parent = arrays(jidx.parent.store) if jidx.parent is not None else None
    bp = IndexBuildParams(nlist=jidx.build_params.nlist, metric=jidx.metric, precision="bf16")
    return index_from_numpy(arrays(jidx.store), parent, jidx.metric, device="cpu",
                            build_params=bp)


@pytest.fixture(scope="module")
def jax_bf16():
    """A JAX bf16 index over 4,000 x 16 vectors, 12 partitions."""
    idx = JaxIndex()
    idx.build(_data(4000, 1), np.arange(4000),
              JaxBuildParams(nlist=12, niter=5, precision="bf16", calibrate_aps=False))
    return idx


# ------------------------------------------------ tests/test_precision.py


def test_bf16_build_and_search(small_data):
    x, ids, q = small_data
    idx = QuakeIndex(device="cpu")
    idx.build(x, ids, IndexBuildParams(nlist=32, precision="bf16", calibrate_aps=False))
    assert idx.store.state.codes.dtype == torch.bfloat16
    res = idx.search(q, SearchParams(k=10, nprobe=32))
    gt_ids, _ = knn(q, x, 10, "l2")
    assert compute_recall(res.ids, gt_ids, 10) >= 0.9


def test_bf16_mutation_and_save_load(tmp_path, small_data):
    x, ids, q = small_data
    idx = QuakeIndex(device="cpu")
    idx.build(x[:2000], ids[:2000], IndexBuildParams(nlist=8, precision="bf16",
                                                     calibrate_aps=False))
    idx.add(x[2000:2100], ids[2000:2100])
    idx.remove(ids[:100])
    assert idx.ntotal() == 2000 and idx.validate()
    idx.save(str(tmp_path / "b"))
    idx2 = QuakeIndex(device="cpu").load(str(tmp_path / "b"))
    assert idx2.store.state.codes.dtype == torch.bfloat16
    r1 = idx.search(q, SearchParams(k=5, nprobe=8))
    r2 = idx2.search(q, SearchParams(k=5, nprobe=8))
    np.testing.assert_array_equal(r1.ids, r2.ids)


def test_bf16_recall_parity_with_f32():
    """The bf16 index's recall within 0.01 of the f32 index's at 50k x 64,
    nlist=64, nprobe=8 (test_precision.py's scale)."""
    rng = np.random.default_rng(7)
    n, d = 50_000, 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((256, d)).astype(np.float32)
    gt_ids, _ = knn(q, x, 10, "l2")
    recalls = {}
    for prec in ("f32", "bf16"):
        idx = QuakeIndex(device="cpu")
        idx.build(x, None, IndexBuildParams(nlist=64, niter=10, precision=prec,
                                            calibrate_aps=False))
        recalls[prec] = compute_recall(idx.search(q, SearchParams(k=10, nprobe=8)).ids,
                                       gt_ids, 10)
    assert recalls["bf16"] >= recalls["f32"] - 0.01, recalls


def test_bf16_checkpoint_is_half_size(tmp_path, small_data):
    x, ids, _ = small_data
    for prec in ("f32", "bf16"):
        idx = QuakeIndex(device="cpu")
        idx.build(x[:4000], ids[:4000], IndexBuildParams(nlist=8, precision=prec,
                                                         calibrate_aps=False))
        idx.save(str(tmp_path / prec))
    f32_sz = os.path.getsize(tmp_path / "f32" / "codes.npy")
    bf16_sz = os.path.getsize(tmp_path / "bf16" / "codes.npy")
    assert bf16_sz <= f32_sz / 2 + 4096
    assert np.load(tmp_path / "bf16" / "codes.npy").dtype == np.uint16


# ------------------------------------------------ parity on one bf16 store


def test_store_rounds_as_jax():
    """The same clustering into both packages' bf16 stores: the same bits."""
    rng = np.random.default_rng(3)
    x = _data(3000, 2) * 7.3  # magnitudes that use every exponent bit of the rounding
    assign = rng.integers(0, 10, 3000).astype(np.int32)
    cents = _data(10, 4)
    js, ts = JaxStore(D, dtype=jnp.bfloat16), PartitionStore(D, "cpu", dtype=torch.bfloat16)
    for s in (js, ts):
        s.init_from_assignments(x, np.arange(3000), cents, assign)
    assert_same_bf16_store(js, ts)


def test_convert_keeps_a_bf16_store_bf16(jax_bf16):
    """ROADMAP Queue 3 repair: a bf16 JAX store carried across stays bf16,
    bit for bit (as numpy hands it over, and as the uint16 bit view)."""
    tidx = carry(jax_bf16)
    assert_same_bf16_store(jax_bf16.store, tidx.store)
    assert tidx.parent.store.state.codes.dtype == torch.float32  # the parent stays f32
    arrays = {f: np.asarray(getattr(jax_bf16.store.state, f)) for f in FIELDS}
    arrays["codes"] = arrays["codes"].view(np.uint16)
    flat = index_from_numpy(arrays, None, device="cpu")
    np.testing.assert_array_equal(_bits(flat.store.state.codes), _bits(jax_bf16.store.state.codes))


def test_mutations_match_jax(jax_bf16, tmp_path):
    """add (with a flood that splits a partition on the host, as in the JAX
    package), remove, modify and get on a carried bf16 store: both stores
    equal after every step."""
    path = str(tmp_path / "j")
    jax_bf16.save(path)
    jidx = JaxIndex().load(path)
    tidx = carry(jidx)
    x = _data(900, 5)
    steps = [("add", x[:600], np.arange(10_000, 10_600)),
             ("remove", np.arange(0, 300)),
             ("modify", np.arange(10_000, 10_050), x[600:650] * 3.1)]
    C = jidx.store.C
    flood = x[650] + 0.001 * _data(int(1.5 * C), 6)
    steps.append(("add", flood, np.arange(50_000, 50_000 + len(flood))))
    for method, *args in steps:
        getattr(jidx, method)(*args)
        getattr(tidx, method)(*args)
        assert_same_bf16_store(jidx.store, tidx.store)
        assert tidx.validate() and tidx.nlist() == jidx.nlist()
    assert jidx.nlist() > 12  # the flood split its partition
    got = tidx.get(np.arange(10_000, 10_050))
    np.testing.assert_array_equal(got, np.asarray(jidx.get(np.arange(10_000, 10_050))))
    assert got.dtype == np.float32


@pytest.mark.parametrize("variant", ["v11", "v10"])
def test_scans_match_jax_pallas(jax_bf16, variant):
    """v11 and v10 on the carried bf16 store with the same probe lists,
    exact distances: row overlap >= 0.99 against the interpret-mode Pallas
    scan, distances of the common ids within rtol 1e-4."""
    tidx = carry(jax_bf16)
    q = _data(64, 9)
    k, nprobe, qt = 10, 4, 16
    st, pst = jax_bf16.store.state, jax_bf16.parent.store.state
    pids = parent_rank_pallas(pst.codes, pst.ids, pst.norms, jnp.asarray(q), nprobe, "l2",
                              interpret=True)
    pids = np.asarray(jnp.where(pids >= 0, pids, pids[:, :1]))
    gpb = int(tidx._grouped_kernel()[len("v11g"):])
    jfn, tfn = {"v11": (grouped_scan_pallas_v11, grouped_scan_v11),
                "v10": (grouped_scan_pallas_v10, grouped_scan_v10)}[variant]
    s1, i1, _ = jfn(st.codes, st.ids, st.sizes, st.norms, jnp.asarray(q), jnp.asarray(pids), k,
                    "l2", qt=qt, gpb=gpb, interpret=True)
    ts = tidx.store.state
    s2, i2, _ = tfn(ts.codes, ts.ids, ts.sizes, ts.norms, torch.from_numpy(q),
                    torch.from_numpy(pids), k, "l2", qt=qt, gpb=gpb)
    i1, s1, i2, s2 = np.asarray(i1), np.asarray(s1), i2.numpy(), s2.numpy()
    assert np.mean([len(set(a) & set(b)) / k for a, b in zip(i1, i2)]) >= 0.99
    same = i1 == i2
    np.testing.assert_allclose(s2[same], s1[same], rtol=1e-4, atol=1e-4)


def test_query_major_and_flat_searches_match_jax(jax_bf16):
    """The query-major IVF search (8 queries) and a flat bf16 index: equal
    ids, distances within rtol 1e-5 (the query rounded to bf16, products
    exact in f32 in both packages)."""
    tidx = carry(jax_bf16)
    q = _data(8, 10)
    a = jax_bf16.search(q, JaxSearchParams(k=5, nprobe=4))
    b = tidx.search(q, SearchParams(k=5, nprobe=4, exact_distances=False))
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_allclose(b.distances, a.distances, rtol=1e-5)
    x = _data(500, 11)
    jflat = JaxIndex()
    jflat.build(x, None, JaxBuildParams(nlist=0, precision="bf16"))
    tflat = carry(jflat)
    assert tflat.parent is None and tflat.store.state.codes.dtype == torch.bfloat16
    for nq in (8, 32):
        qf = _data(nq, 15)
        a = jflat.search(qf, JaxSearchParams(k=5))
        b = tflat.search(qf, SearchParams(k=5, exact_distances=False))
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-5)


def test_gpb_and_placement_follow_the_jax_rule(monkeypatch):
    """ROADMAP Queue 3 repair: the slab counts 2 bytes an element in bf16.
    At the headline shape (C = 7552, D = 128) the JAX package's rule on its
    TPU backend gives gpb 3 for bf16 and 1 for f32, and the port follows it,
    and with it the sorted placement's key budget (rows = ceil(G / gpb) gpb
    qt: at B = 14336, nprobe 8, P = 256 the key fits at gpb 1 and not at gpb
    3, so the f32 rule would pick the sorted placement where the JAX package
    picks argsort)."""
    from quake_tpu_torch.ops.grouped import group_layout
    from quake_tpu_torch.ops.grouped_scan import sort_key_fits

    monkeypatch.setattr(jax_index_module.jax, "default_backend", lambda: "tpu")
    C, d = 7552, 128
    for jdt, want in ((jnp.bfloat16, "v11g3"), (jnp.float32, "v11g1")):
        jidx = JaxIndex()
        jidx.store = JaxStore(d, dtype=jdt)
        jidx.store.init_from_assignments(np.zeros((C, d), np.float32), np.arange(C),
                                         np.zeros((1, d), np.float32), np.zeros(C, np.int32))
        arrays = {f: np.asarray(getattr(jidx.store.state, f)) for f in FIELDS}
        tidx = index_from_numpy(arrays, None, device="cpu")
        assert (jidx.store.C, tidx.store.C) == (C, C)
        assert jidx._grouped_kernel() == tidx._grouped_kernel() == want
        gpb = int(want[len("v11g"):])
        rows = -(-group_layout(14336, 8, 256, 64) // gpb) * gpb * 64
        assert sort_key_fits(14336, rows) == (jdt == jnp.float32)


def test_checkpoints_cross_load(jax_bf16, tmp_path):
    """Each package loads the other's bf16 save: codes equal bit for bit,
    the norms recomputed (rtol 1e-6), searches equal."""
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jax_bf16.save(jpath)
    tl = QuakeIndex(device="cpu").load(jpath)
    assert_same_bf16_store(jax_bf16.store, tl.store)
    tl.save(tpath)
    assert np.load(os.path.join(tpath, "codes.npy")).dtype == np.uint16
    jl = JaxIndex().load(tpath)
    assert_same_bf16_store(jl.store, tl.store)
    q = _data(8, 12)
    np.testing.assert_array_equal(tl.search(q, SearchParams(k=5, nprobe=4)).ids,
                                  jl.search(q, JaxSearchParams(k=5, nprobe=4)).ids)


def test_bf16_parent_is_refused_everywhere(monkeypatch, jax_bf16, tmp_path):
    """Lifted (the name kept as it was): a bf16 parent runs on kernel K3's
    bf16 body. The build, the carry and the load of a bf16 parent succeed
    and match the JAX package: the port's build rounds its parent as JAX
    rounds the same centroids; the carried parent keeps its bits and ranks
    as the JAX package's flat scan does; a save whose parent metadata names
    bf16 loads into both packages with the same parent bits and search ids
    (QUAKE_TPU_KERNEL=xla in both: the exact scan each package runs on the
    CPU)."""
    x = _data(2000, 13)
    bp = IndexBuildParams(nlist=8, calibrate_aps=False,
                          parent_params=IndexBuildParams(precision="bf16"))
    built = QuakeIndex(device="cpu")
    built.build(x, None, bp)
    pst = built.parent.store.state
    assert pst.codes.dtype == torch.bfloat16
    rows = pst.ids.numpy() >= 0
    cents = built.store.state.centroids.numpy()[pst.ids.numpy()[rows]]
    np.testing.assert_array_equal(_bits(pst.codes)[rows], _bits(jnp.asarray(cents, jnp.bfloat16)))

    arrays = {f: np.asarray(getattr(jax_bf16.store.state, f)) for f in FIELDS}
    parent = {f: np.asarray(getattr(jax_bf16.parent.store.state, f)) for f in FIELDS}
    parent["codes"] = np.asarray(jnp.asarray(parent["codes"], jnp.bfloat16))
    carried = index_from_numpy(arrays, parent, device="cpu")
    assert carried.parent.store.state.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(carried.parent.store.state.codes), _bits(parent["codes"]))
    q = _data(32, 14)
    from quake_tpu.ops.scan import flat_scan as jax_flat_scan

    _, want = jax_flat_scan(jnp.asarray(q), jnp.asarray(parent["codes"]).reshape(-1, D),
                            jnp.asarray(parent["ids"]).reshape(-1), 4, "l2", approx=True)
    pst = carried.parent.store.state
    got = coordinator_rank(pst, q, 4)
    np.testing.assert_array_equal(got, np.asarray(want))

    path = str(tmp_path / "j")
    jax_bf16.save(path)
    meta_path = os.path.join(path, "parent", "metadata.json")
    with open(meta_path) as f:
        meta = f.read()
    with open(meta_path, "w") as f:
        f.write(meta.replace('"precision": "f32"', '"precision": "bf16"'))
    monkeypatch.setenv("QUAKE_TPU_KERNEL", "xla")
    tl, jl = QuakeIndex(device="cpu").load(path), JaxIndex().load(path)
    assert tl.parent.store.state.codes.dtype == torch.bfloat16
    assert jl.parent.store.state.codes.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(tl.parent.store.state.codes),
                                  _bits(jl.parent.store.state.codes))
    np.testing.assert_array_equal(tl.search(q, SearchParams(k=5, nprobe=4)).ids,
                                  np.asarray(jl.search(q, JaxSearchParams(k=5, nprobe=4)).ids))


def coordinator_rank(pst, q, nprobe):
    """The port's parent ranking on the CPU ("approx": the flat scan)."""
    from quake_tpu_torch import coordinator

    return coordinator.rank_parents(pst.codes, pst.ids, pst.norms, torch.from_numpy(q), nprobe,
                                    "l2").numpy()


def test_unknown_precision_is_a_value_error():
    with pytest.raises(ValueError, match="precision"):
        QuakeIndex(device="cpu").build(_data(500, 14), None,
                                       IndexBuildParams(nlist=4, precision="fp16",
                                                        calibrate_aps=False))
