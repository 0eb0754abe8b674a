"""The port's index wrappers (quake_tpu_torch/wrappers/) on the CPU.

The registry and the baselines mirror tests/test_misc.py and
tests/test_workload.py against this package's copies. QuakeWrapper is held
to the JAX package's QuakeWrapper on one index: the JAX wrapper builds and
saves it, the port's loads it, and both then take the same adds and
removes, each saves and the other loads: search ids overlap >= 0.99 (the
port's CPU scan is v11, whose quantized keys may reorder a near-tie at the
k-th place) and n_total is equal after every step.
"""

import numpy as np
import pytest

from quake_tpu.wrappers.quake import QuakeWrapper as JaxQuakeWrapper
from quake_tpu_torch.utils import compute_recall, knn
from quake_tpu_torch.wrappers.brute import BruteForceWrapper
from quake_tpu_torch.wrappers.numpy_ivf import NumpyIVF
from quake_tpu_torch.wrappers.quake import QuakeWrapper
from quake_tpu_torch.wrappers.wrapper import IndexWrapper, get_index_class

N, D, NC = 4000, 16, 16


def _data(n, seed, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(r) & set(s)) / max(len(set(s)), 1) for r, s in zip(a, b)]))


def test_wrapper_registry():
    """tests/test_misc.py:96, and every registry name resolves to this
    package's class of the JAX package's name (a baseline whose library is
    missing still resolves: it raises ImportError when constructed)."""
    assert get_index_class("Quake").__name__ == "QuakeWrapper"
    assert get_index_class("QuakeTPU") is QuakeWrapper
    assert get_index_class("BruteForce").__name__ == "BruteForceWrapper"
    assert get_index_class("NumpyIVF") is NumpyIVF
    names = {"IVF": "FaissIVF", "HNSW": "FaissHNSW", "DiskANN": "DiskANNDynamic",
             "ScaNN": "ScaNNWrapper", "SVS": "SVSVamana"}
    for name, cls in names.items():
        c = get_index_class(name)
        assert c.__name__ == cls and c.__module__.startswith("quake_tpu_torch.wrappers.")
        assert issubclass(c, IndexWrapper)
    with pytest.raises(ValueError):
        get_index_class("NoSuchIndex")


@pytest.mark.parametrize("name,module", [("IVF", "faiss"), ("HNSW", "faiss"),
                                         ("DiskANN", "diskannpy"), ("ScaNN", "scann"),
                                         ("SVS", "svs")])
def test_missing_baseline_raises_on_construction(name, module):
    """Without its library a baseline imports and raises ImportError naming
    the library when constructed, as in the JAX package."""
    try:
        __import__(module)
    except ImportError:
        with pytest.raises(ImportError, match=module):
            get_index_class(name)()
    else:
        assert isinstance(get_index_class(name)(), IndexWrapper)


def test_quake_wrapper_defaults_to_the_card():
    """QuakeWrapper() is on the card: it raises where there is none."""
    import torch

    if torch.cuda.is_available():
        assert QuakeWrapper().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            QuakeWrapper()


def test_brute_force_wrapper_roundtrip(tmp_path):
    """tests/test_misc.py:105."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    w = BruteForceWrapper()
    w.build(x, metric="l2")
    res = w.search(x[:5], k=1)
    np.testing.assert_array_equal(res.ids[:, 0], np.arange(5))
    w.add(x[:3] + 100.0)
    assert w.n_total() == 203
    w.remove(np.array([0, 1], dtype=np.int64))
    assert w.n_total() == 201
    w.save(str(tmp_path / "bf"))
    w2 = BruteForceWrapper()
    w2.load(str(tmp_path / "bf"))
    assert w2.n_total() == 201
    assert w2.index_state()["n_total"] == 201


def test_numpy_ivf_wrapper_executes(tmp_path):
    """tests/test_workload.py:202, and the same results as the JAX
    package's NumpyIVF (the same numpy code)."""
    from quake_tpu.wrappers.numpy_ivf import NumpyIVF as JaxNumpyIVF

    assert get_index_class("NumpyIVF") is NumpyIVF
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64)
    q = rng.standard_normal((50, 16)).astype(np.float32)
    gt_ids, _ = knn(q, x, 10, "l2")

    w = NumpyIVF()
    w.build(x, nc=16, metric="l2", ids=ids)
    assert w.n_total() == 5000 and w.d() == 16
    res = w.search(q, k=10, nprobe=16)  # full probe -> exact
    assert compute_recall(res.ids, gt_ids, 10) >= 0.999
    res4 = w.search(q, k=10, nprobe=4)
    r4 = compute_recall(res4.ids, gt_ids, 10)
    assert 0.3 < r4 <= 1.0
    jw = JaxNumpyIVF()
    jw.build(x, nc=16, metric="l2", ids=ids)
    np.testing.assert_array_equal(jw.search(q, k=10, nprobe=4).ids, res4.ids)

    new = rng.standard_normal((100, 16)).astype(np.float32)
    w.add(new, np.arange(10_000, 10_100, dtype=np.int64))
    w.remove(ids[:100])
    assert w.n_total() == 5000
    w.save(str(tmp_path / "ivf"))
    w2 = NumpyIVF()
    w2.load(str(tmp_path / "ivf"))
    assert w2.n_total() == 5000
    np.testing.assert_array_equal(w.search(q, k=5, nprobe=16).ids,
                                  w2.search(q, k=5, nprobe=16).ids)


def test_numpy_ivf_ip_metric():
    """tests/test_workload.py:243."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    gt_ids, _ = knn(q, x, 10, "ip")
    w = NumpyIVF()
    w.build(x, nc=8, metric="ip")
    res = w.search(q, k=10, nprobe=8)
    assert compute_recall(res.ids, gt_ids, 10) >= 0.999


def test_faiss_ivf_wrapper_smoke():
    """tests/test_workload.py:141 on this package's copy; skips without
    faiss, as the JAX test does."""
    pytest.importorskip("faiss")
    from quake_tpu_torch.wrappers.faiss_ivf import FaissIVF

    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64)
    q = rng.standard_normal((50, 16)).astype(np.float32)
    w = FaissIVF()
    w.build(x, nc=16, metric="l2", ids=ids)
    assert w.n_total() == 5000
    res = w.search(q, k=10, nprobe=16)
    gt_ids, _ = knn(q, x, 10, "l2")
    assert compute_recall(res.ids, gt_ids, 10) >= 0.95
    w.add(rng.standard_normal((100, 16)).astype(np.float32),
          np.arange(10_000, 10_100, dtype=np.int64))
    w.remove(ids[:100])
    assert w.n_total() == 5000


def test_faiss_ivfpq_wrapper_smoke():
    """tests/test_workload.py:167 on this package's copy; skips without
    faiss."""
    pytest.importorskip("faiss")
    from quake_tpu_torch.wrappers.faiss_ivf import FaissIVF

    rng = np.random.default_rng(1)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64)
    q = rng.standard_normal((50, 16)).astype(np.float32)
    gt_ids, _ = knn(q, x, 10, "l2")
    w = FaissIVF()
    with pytest.raises(ValueError):
        w.build(x, nc=16, m=4, b=0, ids=ids)
    w.build(x, nc=0, m=4, b=8, ids=ids)
    assert w.index_state()["index_type"] == "pq"
    assert compute_recall(w.search(q, k=10, rf=4).ids, gt_ids, 10) >= 0.8


@pytest.fixture(scope="module")
def saved_jax_wrapper(tmp_path_factory):
    """The JAX package's QuakeWrapper over N vectors, saved once."""
    w = JaxQuakeWrapper()
    w.build(_data(N, 1), nc=NC, metric="l2", ids=np.arange(N, dtype=np.int64))
    path = str(tmp_path_factory.mktemp("jax_wrapper") / "idx")
    w.save(path)
    return path


def _both(path):
    jw, tw = JaxQuakeWrapper(), QuakeWrapper(device="cpu")
    jw.load(path)
    tw.load(path)
    return jw, tw


def _same_search(jw, tw, q, **kw):
    a, b = jw.search(q, **kw), tw.search(q, **kw)
    assert a.ids.shape == b.ids.shape and a.ids.dtype == b.ids.dtype == np.int64
    assert _overlap(b.ids, a.ids) >= 0.99
    return b


def test_quake_wrapper_matches_jax(saved_jax_wrapper, tmp_path):
    """Search, add (ids continuing from get_ids().max() + 1, and given ids),
    remove, maintenance, save and load through both wrappers on one index."""
    jw, tw = _both(saved_jax_wrapper)
    q = _data(40, 2)
    assert (tw.n_total(), tw.d(), tw.metric) == (jw.n_total(), jw.d(), jw.metric)
    assert tw.index_state() == jw.index_state()
    np.testing.assert_array_equal(tw.centroids(), jw.centroids())
    for kw in (dict(k=10, nprobe=4), dict(k=10, nprobe=NC), dict(k=5, nprobe=4,
                                                                 batched_scan=False)):
        _same_search(jw, tw, q, **kw)
    _same_search(jw, tw, q[:8], k=10, nprobe=6)  # B < 16: the query-major path

    x = _data(600, 3)
    for w in (jw, tw):
        w.add(x[:300])  # ids N .. N + 299
        w.add(x[300:], ids=np.arange(20_000, 20_300))
    assert tw.n_total() == jw.n_total() == N + 600
    np.testing.assert_array_equal(np.sort(tw.index.get_ids()), np.sort(jw.index.get_ids()))
    for w in (jw, tw):
        w.remove(np.arange(0, 500))
        w.remove(np.arange(20_000, 20_100))
    assert tw.n_total() == jw.n_total() == N + 600 - 600
    res = _same_search(jw, tw, x[:20], k=10, nprobe=NC)
    assert (res.ids[:, 0] == np.arange(N, N + 20)).all()  # the added vectors find themselves
    for w in (jw, tw):
        w.maintenance()  # the window is not full: no change
    assert tw.n_total() == jw.n_total() and tw.index.validate()

    tw.save(str(tmp_path / "t"))
    jw.save(str(tmp_path / "j"))
    jw2, tw2 = JaxQuakeWrapper(), QuakeWrapper(device="cpu")
    jw2.load(str(tmp_path / "t"))  # each loads what the other saved
    tw2.load(str(tmp_path / "j"), n_workers=0)
    assert tw2.n_total() == jw2.n_total() == tw.n_total()
    _same_search(jw2, tw2, q, k=10, nprobe=4)


def test_quake_wrapper_build_and_recall():
    """The port's own build through the wrapper (k-means with its own
    generator): full-probe recall@10 against the oracle."""
    x, q = _data(3000, 4), _data(30, 5)
    w = QuakeWrapper(device="cpu")
    w.build(x, nc=8, metric="l2", ids=np.arange(3000, dtype=np.int64))
    assert w.n_total() == 3000 and w.d() == D and w.index_state()["n_list"] == 8
    assert w.centroids().shape == (8, D)
    gt, _ = knn(q, x, 10)
    assert compute_recall(w.search(q, k=10, nprobe=8).ids, gt, 10) >= 0.99
    flat = QuakeWrapper(device="cpu")
    flat.build(x, nc=0)
    assert flat.centroids() is None
    assert compute_recall(flat.search(q, k=10).ids, gt, 10) == 1.0
