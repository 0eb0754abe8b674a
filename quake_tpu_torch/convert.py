"""Carry a store across from numpy arrays.

`index_from_numpy` turns the arrays of an index's store and of its parent's
store (`codes`, `ids`, `sizes`, `centroids`, `active`, `norms`, each a numpy
array in the JAX package's layout) into a QuakeIndex of this package, so the
two packages can run on one and the same store. A flat index has one
partition and no parent.

The host bookkeeping of a store that has been mutated is not in its arrays:
the order in which freed rows are taken again, the per-row generation
counters and the capacity rounding. Each mapping may carry them as optional
entries `free_rows`, `generation` and `cap_multiple` (the JAX store's
attributes of those names); without them the inactive rows are free, highest
first, every generation is 0 and the rounding is 128, which is what a freshly
built store has.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from quake_tpu_torch.index import QuakeIndex
from quake_tpu_torch.params import IndexBuildParams, check_metric
from quake_tpu_torch.storage.store import PartitionStore, StoreState

FIELDS = ("codes", "ids", "sizes", "centroids", "active", "norms")
BOOKKEEPING = ("free_rows", "generation", "cap_multiple")
_DTYPES = dict(codes=np.float32, ids=np.int32, sizes=np.int32,
               centroids=np.float32, active=np.bool_, norms=np.float32)


def store_from_numpy(arrays: Mapping[str, np.ndarray], device) -> PartitionStore:
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"store arrays missing: {missing}")
    t = {f: torch.from_numpy(np.array(arrays[f], dtype=_DTYPES[f])) for f in FIELDS}
    P, C, D = t["codes"].shape
    if (tuple(t["ids"].shape) != (P, C) or tuple(t["norms"].shape) != (P, C)
            or tuple(t["sizes"].shape) != (P,) or tuple(t["active"].shape) != (P,)
            or tuple(t["centroids"].shape) != (P, D)):
        raise ValueError("store arrays disagree on P, C or D")
    store = PartitionStore(D, device)
    store.init_from_state(StoreState(**{f: v.to(store.device) for f, v in t.items()}),
                          **{f: arrays.get(f) for f in BOOKKEEPING})
    if len(store.generation) != P:
        raise ValueError(f"generation has {len(store.generation)} rows, the store {P}")
    return store


def index_from_numpy(state: Mapping[str, np.ndarray],
                     parent_state: Optional[Mapping[str, np.ndarray]], metric: str = "l2",
                     device=None, build_params: Optional[IndexBuildParams] = None) -> QuakeIndex:
    """A QuakeIndex over the given store arrays (and bookkeeping, see the
    module's docstring): two levels (index and flat parent), or a flat index
    when parent_state is None. device=None means CUDA, as for QuakeIndex.
    build_params, where given, carries the source index's parameters (its
    mutation_buffer_size, for one)."""
    index = QuakeIndex(device=device)
    index.metric = check_metric(metric)
    index.build_params = build_params
    index.store = store_from_numpy(state, index.device)
    if parent_state is not None:
        index.parent = QuakeIndex(level=1, device=index.device)
        index.parent.metric = index.metric
        index.parent.store = store_from_numpy(parent_state, index.device)
    return index
