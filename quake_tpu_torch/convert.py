"""Carry a store across from numpy arrays.

`index_from_numpy` turns the arrays of an index's store and of its parents'
stores (`codes`, `ids`, `sizes`, `centroids`, `active`, `norms`, each a numpy
array in the JAX package's layout) into a QuakeIndex of this package, so the
two packages can run on one and the same store. A flat index has one
partition and no parent; a two-level index has one parent, flat; an index of
three levels or more has a chain of parents, each an IVF index over the
centroids of the level below, the last one flat.

The host bookkeeping of a store that has been mutated is not in its arrays:
the order in which freed rows are taken again, the per-row generation
counters and the capacity rounding. Each mapping may carry them as optional
entries `free_rows`, `generation` and `cap_multiple` (the JAX store's
attributes of those names); without them the inactive rows are free, highest
first, every generation is 0 and the rounding is 128, which is what a freshly
built store has.

The codes keep their dtype: f32 stays f32, and bf16 stays bf16 bit for bit.
A bf16 array arrives as the JAX package hands it over (numpy's view of a
`jnp.bfloat16` array, whose dtype is named "bfloat16") or as the uint16 bit
view its checkpoints hold; either is read through its 16 bits, so this
module needs no bf16 type of numpy's.

A SOAR-spilled store (every vector in two partitions) needs its two id maps,
because which copy is primary is not in the arrays: the mapping carries them
as `id_map` and `spill_map`, each a (keys, rows) pair (the JAX store's
`id_map.items()` and `spill_map.items()`). `index_from_numpy` marks the
index spilled where the store is, with the given `soar_lambda`.

Maintenance adds no field here: each IVF level made here gets a fresh
policy with an empty hit window and the default latency grid (the packaged
H100 grid on a CUDA device, the analytic model on the CPU), as a load does
without latency_profile.csv. A latency grid crosses between the packages
through `save` and `load` (latency_profile.csv, the same bytes in both).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from quake_tpu_torch.index import QuakeIndex
from quake_tpu_torch.params import IndexBuildParams, MaintenancePolicyParams, check_metric
from quake_tpu_torch.storage.idmap import make_id_map
from quake_tpu_torch.storage.store import PartitionStore, StoreState

FIELDS = ("codes", "ids", "sizes", "centroids", "active", "norms")
BOOKKEEPING = ("free_rows", "generation", "cap_multiple")
MAPS = ("id_map", "spill_map")  # (keys, rows) pairs; a spilled store needs both
_DTYPES = dict(ids=np.int32, sizes=np.int32, centroids=np.float32, active=np.bool_,
               norms=np.float32)


def codes_tensor(codes) -> torch.Tensor:
    """A CPU tensor of a store's codes: bf16 for a bf16 array (dtype name
    "bfloat16") or its uint16 bit view, the bits kept; f32 for anything
    else."""
    a = np.asarray(codes)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def store_from_numpy(arrays: Mapping[str, np.ndarray], device) -> PartitionStore:
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"store arrays missing: {missing}")
    t = {f: torch.from_numpy(np.array(arrays[f], dtype=_DTYPES[f])) for f in _DTYPES}
    t["codes"] = codes_tensor(arrays["codes"])
    P, C, D = t["codes"].shape
    if (tuple(t["ids"].shape) != (P, C) or tuple(t["norms"].shape) != (P, C)
            or tuple(t["sizes"].shape) != (P,) or tuple(t["active"].shape) != (P,)
            or tuple(t["centroids"].shape) != (P, D)):
        raise ValueError("store arrays disagree on P, C or D")
    store = PartitionStore(D, device, dtype=t["codes"].dtype)
    spill = arrays.get("spill_map") is not None
    if spill and arrays.get("id_map") is None:
        raise ValueError("a spilled store needs its id_map beside its spill_map")
    store.init_from_state(StoreState(**{f: v.to(store.device) for f, v in t.items()}),
                          spill=spill, **{f: arrays.get(f) for f in BOOKKEEPING})
    if len(store.generation) != P:
        raise ValueError(f"generation has {len(store.generation)} rows, the store {P}")
    for name in MAPS:
        if arrays.get(name) is not None:
            keys, rows = (np.asarray(a) for a in arrays[name])
            id_map = make_id_map(len(keys))
            id_map.set_batch(keys.astype(np.int64), rows.astype(np.int32))
            setattr(store, name, id_map)
    return store


def index_from_numpy(state: Mapping[str, np.ndarray],
                     parent_state: Union[Mapping[str, np.ndarray],
                                         Sequence[Mapping[str, np.ndarray]], None],
                     metric: str = "l2", device=None,
                     build_params: Optional[IndexBuildParams] = None,
                     soar_lambda: float = 1.0) -> QuakeIndex:
    """A QuakeIndex over the given store arrays (and bookkeeping and maps,
    see the module's docstring): a flat index where parent_state is None,
    two levels (index and flat parent) where it is one mapping, and one
    level more for each further mapping where it is a sequence of them,
    from the level just above the index to the flat top. device=None means
    CUDA, as for QuakeIndex. build_params, where given, carries the source
    index's parameters (its mutation_buffer_size, for one); soar_lambda is a
    spilled index's SOAR weight (what its adds assign with)."""
    index = QuakeIndex(device=device)
    index.metric = check_metric(metric)
    index.build_params = build_params
    index.store = store_from_numpy(state, index.device)
    index.spill = index.store.spill
    index.soar_lambda = float(soar_lambda)
    if parent_state is None:
        return index
    chain = [parent_state] if isinstance(parent_state, Mapping) else list(parent_state)
    below = index
    for level, arrays in enumerate(chain, start=1):
        store = store_from_numpy(arrays, index.device)
        below.parent = QuakeIndex(level=level, device=index.device)
        below.parent.metric = index.metric
        below.parent.store = store
        below = below.parent
    level = index  # every IVF level gets its policy
    while level.parent is not None:
        level.initialize_maintenance_policy(MaintenancePolicyParams())
        level = level.parent
    return index
