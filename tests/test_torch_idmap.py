"""The port's id maps (quake_tpu_torch/storage/idmap.py, native/idmap.py):
tests/test_idmap.py's cases for both backends, and the native map held to
quake_tpu.native.idmap.NativeIdMap on a seeded sequence of operations. The
backends list items() in different orders, so id sets compare sorted."""

import numpy as np
import pytest

from quake_tpu.native.idmap import NativeIdMap as JaxNativeIdMap
from quake_tpu_torch.native import idmap as native
from quake_tpu_torch.native.idmap import NativeIdMap, native_available
from quake_tpu_torch.storage.idmap import PyIdMap, make_id_map

BACKENDS = [PyIdMap, NativeIdMap]


@pytest.mark.parametrize("cls", BACKENDS)
def test_set_get_erase(cls):
    m = cls(16)
    keys = np.arange(100, dtype=np.int64) * 7
    vals = (np.arange(100) % 13).astype(np.int32)
    assert m.set_batch(keys, vals) == 100
    assert len(m) == 100
    np.testing.assert_array_equal(m.get_batch(keys), vals)
    assert m.get_batch(np.array([999999], dtype=np.int64))[0] == -1
    # An update is not an insert.
    assert m.set_batch(keys[:10], vals[:10] + 1) == 0
    np.testing.assert_array_equal(m.get_batch(keys[:10]), vals[:10] + 1)
    expected = vals.copy()
    expected[:10] += 1
    assert m.erase_batch(keys[::2]) == 50
    assert len(m) == 50
    assert (m.get_batch(keys[::2]) == -1).all()
    np.testing.assert_array_equal(m.get_batch(keys[1::2]), expected[1::2])


@pytest.mark.parametrize("cls", BACKENDS)
def test_growth_and_items(cls):
    m = cls(4)
    n = 10_000
    keys = np.random.default_rng(0).permutation(n).astype(np.int64)
    vals = (keys % 31).astype(np.int32)
    m.set_batch(keys, vals)
    assert len(m) == n
    k, v = m.items()
    order = np.argsort(k)
    np.testing.assert_array_equal(k[order], np.sort(keys))
    np.testing.assert_array_equal(v[order], np.sort(keys) % 31)


@pytest.mark.parametrize("cls", BACKENDS)
def test_contains_and_rows_of(cls):
    m = cls(16)
    m.set_batch(np.array([1, 2, 3], dtype=np.int64), np.array([5, 5, 7], dtype=np.int32))
    got = m.contains_batch(np.array([1, 4, 3], dtype=np.int64))
    np.testing.assert_array_equal(got, [True, False, True])
    rows = np.sort(m.rows_of(np.array([1, 2, 3, 4], dtype=np.int64)))
    np.testing.assert_array_equal(rows, [5, 7])


@pytest.mark.parametrize("cls", BACKENDS)
def test_reinsert_after_erase(cls):
    """Tombstones: erased keys can be inserted again."""
    m = cls(8)
    keys = np.arange(64, dtype=np.int64)
    m.set_batch(keys, keys.astype(np.int32))
    m.erase_batch(keys)
    assert len(m) == 0
    assert m.set_batch(keys, (keys + 1).astype(np.int32)) == 64
    np.testing.assert_array_equal(m.get_batch(keys), keys + 1)


def test_native_is_preferred_where_it_builds(monkeypatch):
    """make_id_map returns the native map where g++ builds it (every machine
    the port runs on), and the dict map where it does not."""
    assert native_available()
    assert isinstance(make_id_map(16), NativeIdMap)
    monkeypatch.setattr("quake_tpu_torch.storage.idmap.native_available", lambda: False)
    assert isinstance(make_id_map(16), PyIdMap)


def test_native_library_is_the_ports_own_build():
    """Built from quake_tpu_torch/native/idmap.cpp into quake_tpu_torch/_build/,
    named by the hash of the source and flags; the JAX package's library in
    quake_tpu/native/ is never loaded by the port."""
    make_id_map(4)
    path = native.library_path()
    assert path.is_file() and path.parent.name == "_build"
    assert path.parent.parent.name == "quake_tpu_torch"
    assert native.SRC.parent.parent.name == "quake_tpu_torch"
    assert native._lib._name == str(path)
    assert "quake_tpu/native" not in native._lib._name


def _sorted_items(m):
    k, v = m.items()
    order = np.argsort(k)
    return k[order], v[order]


def test_native_matches_the_jax_native_map():
    """A seeded sequence of inserts, updates, erases and re-inserts: the
    port's native map gives the JAX package's native map's lookups,
    membership, rows and sorted items, and the dict map's sorted items."""
    rng = np.random.default_rng(7)
    ours, theirs, fallback = NativeIdMap(8), JaxNativeIdMap(8), PyIdMap(8)
    universe = rng.permutation(1 << 20)[:5000].astype(np.int64)
    for _ in range(40):
        keys = rng.choice(universe, int(rng.integers(1, 400)), replace=False)
        if rng.integers(0, 3) < 2:
            vals = rng.integers(0, 512, len(keys)).astype(np.int32)
            n = ours.set_batch(keys, vals)
            assert n == theirs.set_batch(keys, vals) == fallback.set_batch(keys, vals)
        else:
            n = ours.erase_batch(keys)
            assert n == theirs.erase_batch(keys) == fallback.erase_batch(keys)
        probe = rng.choice(universe, 300, replace=False)
        np.testing.assert_array_equal(ours.get_batch(probe), theirs.get_batch(probe))
        np.testing.assert_array_equal(ours.contains_batch(probe), theirs.contains_batch(probe))
        np.testing.assert_array_equal(ours.rows_of(probe), theirs.rows_of(probe))
        assert len(ours) == len(theirs) == len(fallback)
    for want in (theirs, fallback):
        for a, b in zip(_sorted_items(ours), _sorted_items(want)):
            np.testing.assert_array_equal(a, b)
