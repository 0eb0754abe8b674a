"""Partition storage: padded fixed-capacity slabs in device memory (a port
of quake_tpu/storage/store.py).

All partitions live in one padded tensor `codes [P, C, D]` with a
compact-prefix invariant: slot j of partition p is valid iff j < sizes[p],
and ids[p, j] == -1 marks invalid slots. The layout, the capacity rounding,
the partition-axis padding and every mutation's result are the JAX
package's, so the same sequence of calls leaves both packages' stores with
the same arrays (the cached norms are f32 sums, equal up to their order of
summation). The codes are f32 or bf16 (`PartitionStore(..., dtype=...)`,
IndexBuildParams.precision): every write rounds to the store's dtype, as
the JAX package's `.astype(state.codes.dtype)` does, and the cached norms
are the f32 squared norms of the rounded codes.

The device functions (`_append`, `_remove_compact`, ...) update the state's
tensors in place where the JAX package donates its buffers; growth
(`_grow_capacity`, `_grow_partitions`) allocates new contiguous tensors,
which the kernels' tensor maps need (16-byte aligned, rows of D floats). Row
arguments take -1 as padding, and a write outside the tensors is dropped, as
JAX's `mode="drop"` scatters do. The cached norms stay in step with the
codes after every mutation: the scan kernels read them and never recompute
them. Host-side bookkeeping (free rows, generation counters, the resident-id map)
lives in PartitionStore.

A SOAR-spilled store (IndexBuildParams.spill) holds every vector twice, in
two different partitions: `id_map` tracks the primary copy's row and
`spill_map` the spill copy's, both the same native map type, and ntotal
stays logical. Every mutation keeps each copy in the map that owns it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from quake_tpu_torch.profiling import annotate
from quake_tpu_torch.storage.idmap import make_id_map
from quake_tpu_torch.utils import next_pow2, to_i64

MIN_CAPACITY = 256  # per-partition capacity floor


@dataclass
class StoreState:
    codes: torch.Tensor  # [P, C, D] float32 or bfloat16
    ids: torch.Tensor  # [P, C] int32, -1 = invalid slot
    sizes: torch.Tensor  # [P] int32
    centroids: torch.Tensor  # [P, D] float32
    active: torch.Tensor  # [P] bool
    # Cached squared L2 norms of the stored codes, [P, C] f32: the scan reads
    # them instead of recomputing ||x||^2 per slab.
    norms: torch.Tensor


def _sumsq(v, dtype=None):
    """Squared L2 norms in f32 of values as they are stored in `dtype`
    (default: v's own), rounded first (quake_tpu/storage/store.py::_sumsq)."""
    vf = v.to(dtype or v.dtype).to(torch.float32)
    return torch.sum(vf * vf, dim=-1)


def _init_from_assignments(x, vids, centroids, assignments, P: int, C: int):
    """Scatter vectors into slabs by cluster (partition_manager.cpp:33-121).
    All inputs are tensors on the store's device; x is in the store's dtype."""
    n, d = x.shape
    dev = x.device
    nlist = centroids.shape[0]
    order = torch.argsort(assignments, stable=True)
    a_sorted = assignments[order]
    x_sorted = x[order]
    counts = torch.bincount(assignments, minlength=P)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(n, device=dev) - starts[a_sorted]

    codes = torch.zeros((P, C, d), device=dev, dtype=x.dtype)
    codes[a_sorted, slots] = x_sorted
    ids = torch.full((P, C), -1, device=dev, dtype=torch.int32)
    ids[a_sorted, slots] = vids[order].to(torch.int32)
    norms = torch.zeros((P, C), device=dev, dtype=torch.float32)
    norms[a_sorted, slots] = _sumsq(x_sorted)
    cents = torch.zeros((P, d), device=dev, dtype=torch.float32)
    cents[:nlist] = centroids
    active = torch.zeros(P, device=dev, dtype=torch.bool)
    active[:nlist] = True
    return StoreState(codes, ids, counts.to(torch.int32), cents, active, norms)


# ---------------------------------------------------------------------------
# Device functions (quake_tpu/storage/store.py:85-236)
# ---------------------------------------------------------------------------


def _append(state: StoreState, rows, vecs, vids) -> StoreState:
    """Append n vectors to their target rows. rows [n] int32, -1 = skip (pad).
    A vector takes its row's size plus its rank among the batch's vectors
    for the same row (in batch order)."""
    n = rows.shape[0]
    P, C = state.ids.shape
    valid = rows >= 0
    order = torch.argsort(rows, stable=True)
    r_sorted = rows[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=rows.device),
                      r_sorted[1:] == r_sorted[:-1]])
    idx = torch.arange(n, dtype=torch.int64, device=rows.device)
    group_start = torch.cummax(torch.where(same, 0, idx), 0).values
    slot_sorted = state.sizes[r_sorted.clamp(min=0).long()].long() + idx - group_start
    slots = torch.empty_like(slot_sorted)
    slots[order] = slot_sorted
    keep = valid & (slots < C)  # a slot past C is dropped, as JAX's scatter drops it
    r, s, v = rows[keep].long(), slots[keep], vecs[keep].to(state.codes.dtype)
    state.codes[r, s] = v
    state.ids[r, s] = vids[keep].to(torch.int32)
    state.norms[r, s] = _sumsq(v)
    state.sizes += torch.bincount(rows[valid].long(), minlength=P).to(torch.int32)
    return state


def _remove_compact(state: StoreState, rows, remove_ids_sorted):
    """Remove by id from the given rows and compact each row's prefix.

    Swap-with-last removal (index_partition.cpp:79-102) becomes a stable
    keep-first permutation per row, so the slots past the new size keep the
    stale codes and norms in the same order as in the JAX package. rows [m]
    int32 distinct (-1 = pad); remove_ids_sorted [r] int32 ascending (pad
    with int32 max). Returns (state, number of ids removed)."""
    r = rows[rows >= 0].long()
    sub_ids = state.ids[r]  # [m, C]
    pos = torch.searchsorted(remove_ids_sorted, sub_ids).clamp(max=remove_ids_sorted.shape[0] - 1)
    hit = (remove_ids_sorted[pos] == sub_ids) & (sub_ids >= 0)
    keep = (sub_ids >= 0) & ~hit
    perm = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)  # kept slots first
    D = state.codes.shape[2]
    state.codes[r] = torch.gather(state.codes[r], 1, perm[:, :, None].expand(-1, -1, D))
    state.ids[r] = torch.gather(torch.where(keep, sub_ids, -1), 1, perm)
    state.norms[r] = torch.gather(state.norms[r], 1, perm)
    state.sizes[r] = keep.sum(1).to(torch.int32)
    return state, hit.sum()


def _find(state: StoreState, rows, vids):
    """(found [m] bool, row [m], slot [m]) of each id in its row (rows -1 =
    pad, row 0 in their place): the first matching slot, as JAX's argmax."""
    valid = rows >= 0
    safe = torch.where(valid, rows, 0).long()
    match = state.ids[safe] == vids[:, None].to(torch.int32)  # [m, C]
    return match.any(1) & valid, safe, match.to(torch.uint8).argmax(1)


def _get_vectors(state: StoreState, rows, vids):
    """Fetch vectors by (row, id). Returns (vecs [m, D] f32, found [m] bool)."""
    found, safe, slot = _find(state, rows, vids)
    vecs = state.codes[safe, slot].to(torch.float32)
    return torch.where(found[:, None], vecs, 0.0), found


def _write_partitions(state: StoreState, rows, vecs, vids, sizes, centroids) -> StoreState:
    """Replace whole partitions (used by split/refine). vecs [m, C, D]."""
    valid = rows >= 0
    r = rows[valid].long()
    v = vecs[valid].to(state.codes.dtype)
    state.codes[r] = v
    state.ids[r] = vids[valid].to(torch.int32)
    state.sizes[r] = sizes[valid].to(torch.int32)
    state.centroids[r] = centroids[valid].to(torch.float32)
    state.active[r] = True
    state.norms[r] = _sumsq(v)
    return state


def _update_vectors(state: StoreState, rows, vids, vecs) -> StoreState:
    """Overwrite existing vectors in place (quake_index.h modify)."""
    found, safe, slot = _find(state, rows, vids)
    r, s, v = safe[found], slot[found], vecs[found].to(state.codes.dtype)
    state.codes[r, s] = v
    state.norms[r, s] = _sumsq(v)
    return state


def _delete_partitions(state: StoreState, rows) -> StoreState:
    """Deactivate rows: no ids, size 0. Their codes and norms stay."""
    r = rows[rows >= 0].long()
    state.ids[r] = -1
    state.sizes[r] = 0
    state.active[r] = False
    return state


def _set_centroids(state: StoreState, rows, centroids) -> StoreState:
    valid = rows >= 0
    state.centroids[rows[valid].long()] = centroids[valid].to(torch.float32)
    return state


def _grow_capacity(state: StoreState, new_C: int) -> StoreState:
    """C -> new_C: new contiguous tensors in the same dtypes, the new slots
    empty (id -1, zero codes and norms). In the span quake.store.grow."""
    pad = new_C - state.ids.shape[1]
    F = torch.nn.functional
    with annotate("quake.store.grow"):
        return StoreState(F.pad(state.codes, (0, 0, 0, pad)),
                          F.pad(state.ids, (0, pad), value=-1), state.sizes, state.centroids,
                          state.active, F.pad(state.norms, (0, pad)))


def _grow_partitions(state: StoreState, new_P: int) -> StoreState:
    """P -> new_P: new contiguous tensors, the new rows empty and inactive.
    In the span quake.store.grow."""
    pad = new_P - state.ids.shape[0]
    F = torch.nn.functional
    with annotate("quake.store.grow"):
        return StoreState(F.pad(state.codes, (0, 0, 0, 0, 0, pad)),
                          F.pad(state.ids, (0, 0, 0, pad), value=-1),
                          F.pad(state.sizes, (0, pad)), F.pad(state.centroids, (0, 0, 0, pad)),
                          F.pad(state.active, (0, pad)), F.pad(state.norms, (0, 0, 0, pad)))


def _bucket(n: int, floor: int = 8) -> int:
    """Pad a batch length to a power of two, the JAX package's bucket (there
    it bounds recompilation): the device functions get the padded inputs the
    JAX ones get, so the two can be compared call by call."""
    return next_pow2(max(n, 1), floor)


def _padded(values, length: int, fill, dtype, shape=()) -> np.ndarray:
    out = np.full((length,) + tuple(shape), fill, dtype)
    out[:len(values)] = values
    return out


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


class PartitionStore:
    """Host orchestrator over StoreState (replaces the reference
    PartitionManager's storage duties, src/cpp/src/partition_manager.cpp):
    the free-row list, per-row generation counters (stable partition
    identity for the maintenance hit window), and the resident vector-id ->
    row map for O(1) add validation and remove routing.

    `version` counts the writes to the arrays: every method that writes
    them (construction, append, remove, update, write and delete
    partitions, set_centroids, growth of C or P) assigns `state`, and the
    assignment moves it on. A sharded index rebuilds its shards when it
    has moved (QuakeIndex.shard)."""

    def __init__(self, dimension: int, device, dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"codes are float32 or bfloat16, not {dtype}")
        self.d = int(dimension)
        self.device = torch.device(device)
        self.dtype = dtype
        self.version = 0
        self.state: StoreState | None = None
        self.free_rows: list[int] = []
        self.generation: np.ndarray | None = None  # [P] int64
        self.id_map = make_id_map()
        self.spill_map = None  # the spill copies' rows, on a spilled store
        self.cap_multiple = 128  # capacity rounding granularity

    @property
    def state(self) -> StoreState | None:
        return self._state

    @state.setter
    def state(self, value: StoreState | None) -> None:
        self._state = value
        self.version += 1

    @property
    def spill(self) -> bool:
        return self.spill_map is not None

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
        active = np.ones(self.P, dtype=bool)
        active[np.asarray(self.free_rows, dtype=np.int64)] = False
        return np.flatnonzero(active).astype(np.int64)

    def partition_sizes(self, rows=None) -> np.ndarray:
        """Sizes of all rows, or of `rows` (0 where a row is -1)."""
        sizes = self.state.sizes.cpu().numpy()
        if rows is None:
            return sizes
        rows = np.asarray(rows)
        out = np.zeros(rows.shape, dtype=sizes.dtype)
        ok = rows >= 0
        out[ok] = sizes[rows[ok]]
        return out

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- construction --------------------------------------------------------

    def init_from_assignments(self, x, vids, centroids, assignments, spill_assignments=None,
                              cap_multiple: int = 128):
        """Fill the store from a clustering: C is the largest partition (at
        least MIN_CAPACITY) rounded up to cap_multiple (itself rounded up to
        a multiple of 128, the fold width of the scan kernels); P pads nlist
        to a 128 multiple (at least 8, or 1 for a flat single-partition
        store). spill_assignments: an optional [n] second partition per
        vector (SOAR spill), each vector then stored twice, the primary copy
        in id_map and the spill copy in spill_map."""
        x = np.asarray(x, dtype=np.float32)
        vids_np = to_i64(vids)
        assigns_np = np.asarray(assignments).astype(np.int64)
        n_logical = len(vids_np)
        if spill_assignments is not None:
            x = np.concatenate([x, x])
            vids_np = np.concatenate([vids_np, vids_np])
            assigns_np = np.concatenate([assigns_np,
                                         np.asarray(spill_assignments).astype(np.int64)])
        cents_np = np.asarray(centroids, dtype=np.float32)
        nlist = int(cents_np.shape[0])
        counts = np.bincount(assigns_np, minlength=nlist)
        max_count = int(counts.max(initial=1))
        cm = max(128, -(-int(cap_multiple) // 128) * 128)
        self.cap_multiple = cm
        C = -(-max(MIN_CAPACITY, max_count) // cm) * cm
        P = max(8, -(-nlist // 128) * 128) if nlist > 1 else 1
        dev = self.device
        self.state = _init_from_assignments(
            torch.from_numpy(x).to(dev).to(self.dtype), torch.as_tensor(vids_np).to(dev),
            torch.as_tensor(cents_np).to(dev), torch.as_tensor(assigns_np).to(dev),
            P=P, C=C)
        self.free_rows = list(range(nlist, P))[::-1]
        self.generation = np.zeros(P, dtype=np.int64)
        rows = assigns_np.astype(np.int32)
        self.id_map = make_id_map(n_logical)
        self.id_map.set_batch(vids_np[:n_logical], rows[:n_logical])
        self.spill_map = None
        if spill_assignments is not None:
            self.spill_map = make_id_map(n_logical)
            self.spill_map.set_batch(vids_np[n_logical:], rows[n_logical:])

    def init_single_partition(self, x, vids):
        """Flat-index mode: one partition 0 holding everything
        (quake_index.cpp:68-79). Centroid = mean of data."""
        x = np.asarray(x, dtype=np.float32)
        centroid = np.mean(x, axis=0, keepdims=True, dtype=np.float64).astype(np.float32)
        self.init_from_assignments(x, vids, centroid, np.zeros(x.shape[0], dtype=np.int64))

    def init_from_state(self, state: StoreState, free_rows=None, generation=None,
                        cap_multiple=None, spill: bool = False):
        """Adopt existing store arrays (see quake_tpu_torch.convert and
        QuakeIndex.load), codes in the store's dtype, with the host
        bookkeeping given. Where it is not:
        the inactive rows become the free rows, highest first, every
        generation counter starts at 0, and the capacity rounding is 128. The
        id map is rebuilt from the slots in row-major order; on a spilled
        store (spill) each id's first occurrence goes to id_map and its
        second to spill_map, as the JAX package's load splits them (which
        copy is primary does not matter: the copies are the same vector)."""
        if state.codes.dtype != self.dtype:
            raise ValueError(f"codes are {state.codes.dtype}, the store holds {self.dtype}")
        self.state = state
        if free_rows is None:
            free_rows = np.flatnonzero(~state.active.cpu().numpy())[::-1]
        self.free_rows = [int(r) for r in free_rows]
        self.generation = (np.zeros(self.P, dtype=np.int64) if generation is None
                           else np.array(generation, dtype=np.int64))
        if cap_multiple is not None:
            self.cap_multiple = int(cap_multiple)
        ids = state.ids.cpu().numpy()
        rr, _ = np.nonzero(ids >= 0)
        flat = ids[ids >= 0].astype(np.int64)
        rr = rr.astype(np.int32)
        first = np.ones(len(flat), bool)
        if spill:
            first[:] = False
            first[np.unique(flat, return_index=True)[1]] = True
        self.id_map = make_id_map(int(first.sum()))
        self.id_map.set_batch(flat[first], rr[first])
        self.spill_map = None
        if spill:
            self.spill_map = make_id_map(int((~first).sum()))
            self.spill_map.set_batch(flat[~first], rr[~first])

    # -- mutation -------------------------------------------------------------

    def ensure_capacity(self, incoming_counts: np.ndarray):
        """Grow C if any row would overflow: to next_pow2(need, 2 C) rounded
        up to cap_multiple. incoming_counts: [P]-aligned."""
        sizes = self.partition_sizes()
        need = int((sizes[:len(incoming_counts)] + incoming_counts).max(initial=0))
        if need > self.C:
            cm = self.cap_multiple
            self.state = _grow_capacity(self.state, -(-next_pow2(need, self.C * 2) // cm) * cm)

    def ensure_capacity_multiple(self, multiple: int):
        """Re-bucket C to a multiple of `multiple` (rounded up to 128), and
        make it the growth granularity."""
        cm = max(128, -(-int(multiple) // 128) * 128)
        self.cap_multiple = max(self.cap_multiple, cm)
        new_C = -(-self.C // cm) * cm
        if new_C != self.C:
            self.state = _grow_capacity(self.state, new_C)

    def ensure_rows(self, n_new_rows: int):
        """Room for n_new_rows new partitions: P grows to
        max(ceil128(needed), P + 128), the new rows free (taken first)."""
        if n_new_rows <= len(self.free_rows):
            return
        old_P = self.P
        needed = old_P + n_new_rows - len(self.free_rows)
        new_P = max(-(-needed // 128) * 128, old_P + 128)
        self.state = _grow_partitions(self.state, new_P)
        self.free_rows = list(range(old_P, new_P))[::-1] + self.free_rows
        self.generation = np.concatenate([self.generation,
                                          np.zeros(new_P - old_P, dtype=np.int64)])

    def append(self, rows: np.ndarray, vecs: np.ndarray, vids: np.ndarray, spill_rows=None):
        """Append vectors to rows (already validated and assigned).
        spill_rows: the second partition of each vector on a spilled store;
        the vectors are appended twice, the spill copies first (the JAX
        package's order), and spill_map tracks them."""
        if spill_rows is not None:
            self._append_one(np.asarray(spill_rows), vecs, vids, self.spill_map)
        self._append_one(np.asarray(rows), vecs, vids, self.id_map)

    def append_spill_copies(self, rows: np.ndarray, vecs: np.ndarray, vids: np.ndarray):
        """Append only the spill copy of each vector (rows may hold -1 for
        copies already written elsewhere, by a split)."""
        self._append_one(np.asarray(rows), vecs, vids, self.spill_map)

    def append_primaries(self, rows: np.ndarray, vecs: np.ndarray, vids: np.ndarray):
        """Append only the primary copy of each vector (rows may hold -1)."""
        self._append_one(np.asarray(rows), vecs, vids, self.id_map)

    def _append_one(self, rows: np.ndarray, vecs: np.ndarray, vids: np.ndarray, id_map):
        """One copy of each vector into its row (-1: none), in the span
        quake.store.append."""
        with annotate("quake.store.append"):
            n = len(rows)
            self.ensure_capacity(np.bincount(rows[rows >= 0], minlength=self.P))
            b = _bucket(n)
            self.state = _append(self.state, self._tensor(_padded(rows, b, -1, np.int32)),
                                 self._tensor(_padded(vecs, b, 0, np.float32, (self.d,))),
                                 self._tensor(_padded(vids, b, -1, np.int64)))
            ok = rows[:n] >= 0
            id_map.set_batch(np.asarray(vids[:n])[ok], rows[:n][ok].astype(np.int32))

    def remove(self, vids: np.ndarray) -> int:
        """Remove vector ids (ids not resident are ignored), routed through
        the id map to the rows that hold them; on a spilled store both
        copies go, an id resident in either map counting as present.
        Returns how many were resident. In the span quake.store.remove."""
        with annotate("quake.store.remove"):
            vids = to_i64(vids)
            lookup = self.id_map.get_batch(vids)
            present_mask = lookup >= 0
            rows = lookup[lookup >= 0]
            if self.spill_map is not None:
                lookup2 = self.spill_map.get_batch(vids)
                present_mask |= lookup2 >= 0
                rows = np.concatenate([rows, lookup2[lookup2 >= 0]])
            present = vids[present_mask]
            if len(present) == 0:
                return 0
            rows = np.unique(rows)
            rem = _padded(np.sort(present), _bucket(len(present)), np.iinfo(np.int32).max, np.int32)
            self.state, _ = _remove_compact(
                self.state, self._tensor(_padded(rows, _bucket(len(rows)), -1, np.int32)),
                self._tensor(rem))
            self.id_map.erase_batch(present)
            if self.spill_map is not None:
                self.spill_map.erase_batch(present)
            return len(present)

    def update_vectors(self, vids: np.ndarray, vecs: np.ndarray):
        """Overwrite resident vectors by id (used by parent.modify); on a
        spilled store both copies."""
        vids = to_i64(vids)
        if self.spill_map is not None:
            self._update_one(vids, vecs, self.spill_map)
        self._update_one(vids, vecs, self.id_map)

    def _update_one(self, vids: np.ndarray, vecs: np.ndarray, id_map):
        b = _bucket(len(vids))
        self.state = _update_vectors(
            self.state, self._tensor(_padded(id_map.get_batch(vids), b, -1, np.int32)),
            self._tensor(_padded(vids, b, -1, np.int64)),
            self._tensor(_padded(vecs, b, 0, np.float32, (self.d,))))

    def get_vectors(self, vids: np.ndarray):
        """Fetch vectors by id through the primary copies
        (partition_manager.cpp:322-341).

        Returns (vecs [m, d] f32, found [m] bool)."""
        vids = to_i64(vids)
        m = len(vids)
        b = _bucket(m)
        vecs, found = _get_vectors(
            self.state, self._tensor(_padded(self.id_map.get_batch(vids), b, -1, np.int32)),
            self._tensor(_padded(vids, b, -1, np.int64)))
        return vecs.cpu().numpy()[:m], found.cpu().numpy()[:m]

    def allocate_rows(self, n: int) -> list[int]:
        """Take n free rows (growing P if needed); each one's generation
        counter moves on."""
        self.ensure_rows(n)
        rows = [self.free_rows.pop() for _ in range(n)]
        for r in rows:
            self.generation[r] += 1
        return rows

    def write_partitions(self, rows, vecs_list, vids_list, centroids, spill_flags_list=None):
        """Write whole partitions (split/refine): lists of per-partition
        arrays. A partition larger than C grows C to next_pow2(size, 2 C),
        without cap_multiple's rounding, as the JAX package does.
        spill_flags_list (a spilled store): per partition, True where the
        written copy is the vector's spill copy (spill_map), False for the
        primary (id_map)."""
        m = len(rows)
        max_sz = max((len(v) for v in vids_list), default=1)
        if max_sz > self.C:
            self.state = _grow_capacity(self.state, next_pow2(max_sz, self.C * 2))
        mb = _bucket(m, 1)
        vecs_p = np.zeros((mb, self.C, self.d), np.float32)
        vids_p = np.full((mb, self.C), -1, np.int64)
        sizes_p = np.zeros(mb, np.int32)
        for i in range(m):
            sz = len(vids_list[i])
            vecs_p[i, :sz] = vecs_list[i]
            vids_p[i, :sz] = vids_list[i]
            sizes_p[i] = sz
        self.state = _write_partitions(
            self.state, self._tensor(_padded(rows, mb, -1, np.int32)), self._tensor(vecs_p),
            self._tensor(vids_p), self._tensor(sizes_p),
            self._tensor(_padded(np.asarray(centroids, np.float32)[:m], mb, 0, np.float32,
                                 (self.d,))))
        kept = [i for i in range(m) if len(vids_list[i])]
        if not kept:
            return
        keys = np.concatenate([np.asarray(vids_list[i], np.int64) for i in kept])
        vals = np.concatenate([np.full(len(vids_list[i]), rows[i], np.int32) for i in kept])
        if spill_flags_list is None:
            self.id_map.set_batch(keys, vals)
            return
        flags = np.concatenate([np.asarray(spill_flags_list[i], bool) for i in kept])
        if (~flags).any():
            self.id_map.set_batch(keys[~flags], vals[~flags])
        if flags.any():
            self.spill_map.set_batch(keys[flags], vals[flags])

    def delete_partitions(self, rows):
        """Deactivate rows; the ids within them leave the resident map (on a
        spilled store, the map whose copy lived in the row: the twin's stays),
        and the rows return to the free list with their generation moved on."""
        rows_arr = np.asarray(rows, dtype=np.int64)
        ids_np = self.state.ids[torch.from_numpy(rows_arr).to(self.device)].cpu().numpy()
        if self.spill_map is None:
            gone = ids_np[ids_np >= 0].astype(np.int64)
            if len(gone):
                self.id_map.erase_batch(gone)
        else:
            for ri, r in enumerate(rows_arr):
                gone = ids_np[ri][ids_np[ri] >= 0].astype(np.int64)
                for id_map in (self.id_map, self.spill_map):
                    here = id_map.get_batch(gone) == r
                    if here.any():
                        id_map.erase_batch(gone[here])
        self.state = _delete_partitions(
            self.state, self._tensor(_padded(rows_arr, _bucket(len(rows), 1), -1, np.int32)))
        for r in sorted(rows, reverse=True):
            self.generation[r] += 1
            self.free_rows.append(int(r))

    def set_centroids(self, rows, centroids):
        mb = _bucket(len(rows), 1)
        self.state = _set_centroids(
            self.state, self._tensor(_padded(rows, mb, -1, np.int32)),
            self._tensor(_padded(np.asarray(centroids, np.float32), mb, 0, np.float32,
                                 (self.d,))))

    def get_partition(self, row: int):
        """Host copy of one partition's (vectors as f32, ids)."""
        sz = int(self.state.sizes[row])
        codes = self.state.codes[row, :sz].to(torch.float32).cpu().numpy()
        ids = self.state.ids[row, :sz].cpu().numpy().astype(np.int64)
        return codes, ids

    def get_ids(self) -> np.ndarray:
        return self.id_map.items()[0]
