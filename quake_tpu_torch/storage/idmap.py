"""Resident-id registry: vector id -> partition row.

Batch-oriented API with two backends, as in quake_tpu/storage/idmap.py: the
native C++ open-addressing map (quake_tpu_torch/native/idmap.cpp, built with
g++ at first use) and a dict fallback for a machine without g++.
`make_id_map` prefers the native map. Replaces the reference's resident_ids_
set + O(ntotal) id scans (partition_manager.cpp:163-184,
dynamic_inverted_list.cpp:137-149). The backends return items() in different
orders, so callers that compare id sets sort them.
"""

from __future__ import annotations

import numpy as np

from quake_tpu_torch.native.idmap import NativeIdMap, native_available


class PyIdMap:
    """Dict-backed fallback with the same batch API as NativeIdMap."""

    def __init__(self, initial_capacity: int = 1024):
        self._d: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._d)

    def set_batch(self, keys, values) -> int:
        d = self._d
        before = len(d)
        for k, v in zip(np.asarray(keys, np.int64).tolist(),
                        np.asarray(values, np.int32).tolist()):
            d[k] = v
        return len(d) - before

    def get_batch(self, keys) -> np.ndarray:
        d = self._d
        return np.fromiter(
            (d.get(k, -1) for k in np.asarray(keys, np.int64).tolist()),
            dtype=np.int32,
            count=len(keys),
        )

    def contains_batch(self, keys) -> np.ndarray:
        d = self._d
        return np.fromiter(
            (k in d for k in np.asarray(keys, np.int64).tolist()),
            dtype=bool,
            count=len(keys),
        )

    def erase_batch(self, keys) -> int:
        d = self._d
        n = 0
        for k in np.asarray(keys, np.int64).tolist():
            if d.pop(k, None) is not None:
                n += 1
        return n

    def items(self):
        keys = np.fromiter(self._d.keys(), dtype=np.int64, count=len(self._d))
        values = np.fromiter(self._d.values(), dtype=np.int32, count=len(self._d))
        return keys, values

    def rows_of(self, keys) -> np.ndarray:
        rows = self.get_batch(keys)
        rows = rows[rows >= 0]
        return np.unique(rows)


def make_id_map(initial_capacity: int = 1024):
    """The native map where it builds (native_available()), else PyIdMap."""
    if native_available():
        return NativeIdMap(initial_capacity)
    return PyIdMap(initial_capacity)
