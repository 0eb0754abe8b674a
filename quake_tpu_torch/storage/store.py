"""Partition storage: padded fixed-capacity slabs in device memory (the
build-time part of quake_tpu/storage/store.py).

All partitions live in one padded tensor `codes [P, C, D]` with a
compact-prefix invariant: slot j of partition p is valid iff j < sizes[p],
and ids[p, j] == -1 marks invalid slots. The layout, the capacity rounding
and the partition-axis padding are the JAX package's, so a store built by
either package holds the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from quake_tpu_torch.storage.idmap import make_id_map
from quake_tpu_torch.utils import to_i64

MIN_CAPACITY = 256  # per-partition capacity floor


@dataclass
class StoreState:
    codes: torch.Tensor  # [P, C, D] float32
    ids: torch.Tensor  # [P, C] int32, -1 = invalid slot
    sizes: torch.Tensor  # [P] int32
    centroids: torch.Tensor  # [P, D] float32
    active: torch.Tensor  # [P] bool
    # Cached squared L2 norms of the stored codes, [P, C] f32: the scan reads
    # them instead of recomputing ||x||^2 per slab.
    norms: torch.Tensor


def _init_from_assignments(x, vids, centroids, assignments, P: int, C: int):
    """Scatter vectors into slabs by cluster (partition_manager.cpp:33-121).
    All inputs are tensors on the store's device."""
    n, d = x.shape
    dev = x.device
    nlist = centroids.shape[0]
    order = torch.argsort(assignments, stable=True)
    a_sorted = assignments[order]
    x_sorted = x[order]
    counts = torch.bincount(assignments, minlength=P)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(n, device=dev) - starts[a_sorted]

    codes = torch.zeros((P, C, d), device=dev, dtype=torch.float32)
    codes[a_sorted, slots] = x_sorted
    ids = torch.full((P, C), -1, device=dev, dtype=torch.int32)
    ids[a_sorted, slots] = vids[order].to(torch.int32)
    norms = torch.zeros((P, C), device=dev, dtype=torch.float32)
    norms[a_sorted, slots] = torch.sum(x_sorted * x_sorted, dim=-1)
    cents = torch.zeros((P, d), device=dev, dtype=torch.float32)
    cents[:nlist] = centroids
    active = torch.zeros(P, device=dev, dtype=torch.bool)
    active[:nlist] = True
    return StoreState(codes, ids, counts.to(torch.int32), cents, active, norms)


class PartitionStore:
    """Host orchestrator over StoreState: free rows and the resident
    vector-id -> row map (replaces the reference
    PartitionManager's storage duties, src/cpp/src/partition_manager.cpp)."""

    def __init__(self, dimension: int, device):
        self.d = int(dimension)
        self.device = torch.device(device)
        self.state: StoreState | None = None
        self.free_rows: list[int] = []
        self.id_map = make_id_map()

    @property
    def P(self) -> int:
        return int(self.state.ids.shape[0])

    @property
    def C(self) -> int:
        return int(self.state.ids.shape[1])

    def nlist(self) -> int:
        return self.P - len(self.free_rows)

    def ntotal(self) -> int:
        return len(self.id_map)

    def active_rows(self) -> np.ndarray:
        """The rows that hold a partition (not free), ascending."""
        free = set(self.free_rows)
        return np.array([r for r in range(self.P) if r not in free], dtype=np.int64)

    def init_from_assignments(self, x, vids, centroids, assignments):
        """Fill the store from a clustering: C is the largest partition (at
        least MIN_CAPACITY) rounded up to a multiple of 128, the fold width
        of the scan kernels; P pads nlist to a 128 multiple (at least 8, or
        1 for a flat single-partition store)."""
        x = torch.as_tensor(np.asarray(x, dtype=np.float32))
        vids_np = to_i64(vids)
        assigns_np = np.asarray(assignments).astype(np.int64)
        cents_np = np.asarray(centroids, dtype=np.float32)
        nlist = int(cents_np.shape[0])
        counts = np.bincount(assigns_np, minlength=nlist)
        max_count = int(counts.max(initial=1))
        C = -(-max(MIN_CAPACITY, max_count) // 128) * 128
        P = max(8, -(-nlist // 128) * 128) if nlist > 1 else 1
        dev = self.device
        self.state = _init_from_assignments(
            x.to(dev), torch.as_tensor(vids_np).to(dev),
            torch.as_tensor(cents_np).to(dev), torch.as_tensor(assigns_np).to(dev),
            P=P, C=C)
        self.free_rows = list(range(nlist, P))[::-1]
        self.id_map = make_id_map(len(vids_np))
        self.id_map.set_batch(vids_np, assigns_np.astype(np.int32))

    def init_single_partition(self, x, vids):
        """Flat-index mode: one partition 0 holding everything
        (quake_index.cpp:68-79). Centroid = mean of data."""
        x = np.asarray(x, dtype=np.float32)
        centroid = np.mean(x, axis=0, keepdims=True, dtype=np.float64).astype(np.float32)
        self.init_from_assignments(x, vids, centroid, np.zeros(x.shape[0], dtype=np.int64))

    def init_from_state(self, state: StoreState):
        """Adopt existing store arrays (see quake_tpu_torch.convert); the
        inactive rows become the free rows, highest first."""
        self.state = state
        active = state.active.cpu().numpy()
        self.free_rows = [int(r) for r in np.flatnonzero(~active)][::-1]
        ids = state.ids.cpu().numpy()
        rows = np.broadcast_to(np.arange(self.P, dtype=np.int32)[:, None], ids.shape)
        ok = ids >= 0
        self.id_map = make_id_map(int(ok.sum()))
        self.id_map.set_batch(ids[ok].astype(np.int64), rows[ok])
