"""Cost-based adaptive maintenance: split hot partitions, delete cold ones,
refine the neighbourhood (the counterpart of
quake_tpu/maintenance/policy.py).

The reference MaintenancePolicy flow (src/cpp/src/maintenance_policies.cpp:
33-202): gate on a full hit window -> aggregate per-partition hit rates ->
delete_delta / split_delta against the ns thresholds (delete rejection by a
simulated reassignment through the parent, :77-119) -> deletes, with the
vectors reassigned, then splits (2-means each) -> local refinement of the
split neighbourhood (radius = the k nearest centroids of the new ones,
:188-202). As in the JAX package, and unlike the reference, the index's
search path feeds the window (QuakeIndex._record_hits).

The parent searches here (reassignment, rejection, neighbourhood) run the
parent's exact flat scan (`parent._search_device`), as the JAX package's do;
the clustering runs batched on the index's device (kmeans.batched_two_means,
batched_refine), or on the host with QUAKE_TPU_MAINT_HOST=1. A spilled index
(each vector in two partitions) takes the host paths, as in the JAX package:
every moved copy keeps its map, a deleted partition's copies are re-homed
away from their twins' partitions, and refinement separates twins that land
in one cluster.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from quake_tpu_torch.kmeans import batched_refine, lloyd_refine_np
from quake_tpu_torch.maintenance.cost_estimator import MaintenanceCostEstimator
from quake_tpu_torch.maintenance.hit_tracker import HitCountTracker
from quake_tpu_torch.params import MaintenancePolicyParams, SearchParams
from quake_tpu_torch.profiling import annotate
from quake_tpu_torch.storage.store import _bucket
from quake_tpu_torch.timing import MaintenanceTimingInfo


def _now_us() -> int:
    return int(time.perf_counter() * 1e6)


def maint_on_host() -> bool:
    """QUAKE_TPU_MAINT_HOST=1: split and refine on the host (kmeans_np,
    lloyd_refine_np), as the JAX package does under the same variable."""
    return os.environ.get("QUAKE_TPU_MAINT_HOST") == "1"


class MaintenancePolicy:
    def __init__(self, index, params: MaintenancePolicyParams):
        self.index = index
        self.params = params
        # k=10 is the reference's estimator k (maintenance_policies.cpp:24-27);
        # a profiled or loaded grid (index.latency_profile) replaces the
        # default one (quake_index.cpp:81-82): the packaged H100 grid on a
        # CUDA index, the analytic model on a CPU one.
        self.cost_estimator = MaintenanceCostEstimator(
            index.d(), params.alpha, 10,
            latency_estimator=getattr(index, "latency_profile", None),
            device=getattr(index, "device", None),
        )
        self.hit_count_tracker = HitCountTracker(params.window_size, max(index.ntotal(), 1))
        # The last round's delete-rejection simulations: how many candidates
        # were simulated (one partition read and one parent search each) and
        # the microseconds they took.
        self.rejection_candidates = 0
        self.rejection_time_us = 0

    # -- recording -------------------------------------------------------------

    def record_query_hits(self, partition_ids):
        """Host-side parity API (maintenance_policies.cpp:179-182)."""
        pids = np.asarray(partition_ids, dtype=np.int64)
        sizes = self.index.store.partition_sizes(pids)
        self.hit_count_tracker.add_query_data(pids, int(sizes.sum()))

    def record_query_hits_device(self, pids_dev, scanned_dev):
        self.hit_count_tracker.add_batch_device(pids_dev, scanned_dev)

    def reset(self):
        self.hit_count_tracker.reset()

    # -- the main loop -----------------------------------------------------------

    def perform_maintenance(self) -> MaintenanceTimingInfo:
        timing = MaintenanceTimingInfo()
        p = self.params
        tracker = self.hit_count_tracker
        self.rejection_candidates = self.rejection_time_us = 0
        if tracker.get_num_queries_recorded() < p.window_size:
            return timing

        t_total = _now_us()
        store = self.index.store
        with annotate("quake.maint.window"):
            sizes = store.partition_sizes()
            agg = tracker.hit_counts(store.P, sizes)

        with annotate("quake.maint.decide"):
            active_rows = store.active_rows()
            total_partitions = len(active_rows)
            if total_partitions <= 1:
                return timing
            ntotal = self.index.ntotal()
            avg_size = ntotal / total_partitions
            scan_fraction = tracker.get_current_scan_fraction()

            # One pass of the cost model over every active row; only the
            # delete-rejection candidates take a step each (a parent search).
            ce = self.cost_estimator
            row_sizes = sizes[active_rows].astype(np.int64)
            hit_rates = agg[active_rows] / p.window_size
            delete_delta = ce.compute_delete_delta_array(
                row_sizes, hit_rates, total_partitions, scan_fraction, avg_size)
            delete = delete_delta < -p.delete_threshold_ns
            splittable = ~delete & (row_sizes > p.min_partition_size)
            split = np.zeros_like(delete)
            split[splittable] = ce.compute_split_delta_array(
                row_sizes[splittable], hit_rates[splittable], total_partitions
            ) < -p.split_threshold_ns
            if p.enable_delete_rejection:
                for i in np.flatnonzero(delete & (row_sizes > p.min_partition_size)):
                    t_rej = _now_us()
                    with annotate("quake.maint.reject"):
                        delta = self._delete_delta_with_reassign(
                            int(active_rows[i]), int(row_sizes[i]), hit_rates[i],
                            total_partitions, agg)
                    self.rejection_candidates += 1
                    self.rejection_time_us += _now_us() - t_rej
                    delete[i] = delta < -p.delete_threshold_ns
            to_delete = active_rows[delete].tolist()
            to_split = active_rows[split].tolist()

            # Never delete everything.
            to_delete = to_delete[:total_partitions - 1]

        t_del = _now_us()
        if to_delete:
            with annotate("quake.maint.delete"):
                self._delete_partitions(to_delete, reassign=True)
            timing.n_deletes = len(to_delete)
        timing.delete_time_us = _now_us() - t_del

        t_split = _now_us()
        new_rows: list[int] = []
        if to_split:
            with annotate("quake.maint.split"):
                new_rows = self._split_partitions(to_split)
            timing.n_splits = len(to_split)
        timing.split_time_us = _now_us() - t_split

        t_refine = _now_us()
        if new_rows:
            with annotate("quake.maint.refine"):
                self.local_refinement(new_rows)
        timing.split_refine_time_us = _now_us() - t_refine

        # Entered only when a row was deleted or split: its calls count how
        # often the invalidation engages.
        if to_delete or to_split:
            with annotate("quake.maint.invalidate"):
                tracker.invalidate_rows(to_delete + to_split)
        timing.total_time_us = _now_us() - t_total
        return timing

    # -- helpers ------------------------------------------------------------------

    def _parent_ids(self, x: np.ndarray, k: int) -> np.ndarray:
        """The k nearest parent entries (partition rows) of each row of x,
        from the parent's exact flat scan on the index's device."""
        q = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.index.device)
        _, ids32, _ = self.index.parent._search_device(q, SearchParams(k=k, batched_scan=True))
        return ids32.cpu().numpy()

    def _delete_delta_with_reassign(self, row, size, hit_rate, total_partitions, agg):
        """Delete rejection: the delta with the vectors reassigned as a k=2
        parent search sends them (maintenance_policies.cpp:77-119)."""
        store = self.index.store
        vecs, _ = store.get_partition(row)
        if vecs.shape[0] == 0:
            return -np.inf  # empty partition: always delete
        reassign = self._parent_ids(vecs, 2).ravel()
        reassign = reassign[(reassign >= 0) & (reassign != row)]
        if reassign.size == 0:
            return 0.0
        uniques, counts = np.unique(reassign, return_counts=True)
        sizes = store.partition_sizes(uniques)
        hit_rates = agg[uniques] / self.params.window_size
        return self.cost_estimator.compute_delete_delta_w_reassign(
            size, hit_rate, total_partitions,
            counts.tolist(), sizes.tolist(), hit_rates.tolist(),
        )

    def _delete_partitions(self, rows, reassign: bool = True):
        """partition_manager.cpp:524-554: the centroids leave the parent,
        the rows are freed, and the orphaned vectors go back in through
        index.add (reassign). On a spilled index each orphan copy keeps its
        map and is re-homed to the best parent candidate that is not its
        twin's partition (quake_tpu/maintenance/policy.py::
        _delete_partitions)."""
        index, store = self.index, self.index.store
        orphans, owned, twins = [], [], []
        for r in rows:
            vecs, vids = store.get_partition(int(r))
            if not vecs.shape[0]:
                continue
            orphans.append((vecs, vids))
            if index.spill:  # ownership and twin row, read before the delete
                prim = store.id_map.get_batch(vids)
                spl = store.spill_map.get_batch(vids)
                was_spill = spl == int(r)
                owned.append(was_spill)
                twins.append(np.where(was_spill, prim, spl).astype(np.int64))
        index.parent.remove(np.asarray(rows, dtype=np.int64))
        store.delete_partitions([int(r) for r in rows])
        if not (reassign and orphans):
            return
        vecs = np.concatenate([o[0] for o in orphans])
        vids = np.concatenate([o[1] for o in orphans])
        if not index.spill:
            index.add(vecs, vids)
            return
        # The ids stay resident through their twins, so index.add's
        # duplicate check cannot take them: each copy goes to its first
        # parent candidate unless that is its twin's partition, else to its
        # second (which is -1 where the parent has one entry: then the first,
        # as in the JAX package; refinement separates such twins later).
        flags = np.concatenate(owned)
        twin = np.concatenate(twins)
        cand = self._parent_ids(vecs, 2).astype(np.int64)
        new_rows = np.where(cand[:, 0] != twin, cand[:, 0], cand[:, 1])
        # Both of an id's partitions deleted: the copies (the same vector,
        # the same candidates) go to the first and the second candidate.
        uniq, counts = np.unique(vids, return_counts=True)
        is_dup = np.isin(vids, uniq[counts > 1])
        new_rows = np.where(is_dup & ~flags, cand[:, 0], new_rows)
        new_rows = np.where(is_dup & flags, cand[:, 1], new_rows)
        new_rows = np.where(new_rows >= 0, new_rows, cand[:, 0]).astype(np.int32)
        if (~flags).any():
            store.append_primaries(new_rows[~flags], vecs[~flags], vids[~flags])
        if flags.any():
            store.append_spill_copies(new_rows[flags], vecs[flags], vids[flags])

    def _split_partitions(self, rows) -> list[int]:
        """2-means each partition; the originals deleted, the halves added
        (partition_manager.cpp:393-445, maintenance_policies.cpp:150-163)."""
        return self.index.split_partitions(rows)

    def local_refinement(self, rows):
        """Refine the neighbourhood of the given (split) partitions: the
        refinement_radius nearest centroids of each
        (maintenance_policies.cpp:188-202)."""
        p = self.params
        if p.refinement_radius == 0 or not rows:
            return
        store = self.index.store
        cents = store.state.centroids[torch.as_tensor(rows, dtype=torch.long,
                                                      device=store.device)]
        k = min(p.refinement_radius, self.index.nlist())
        refine_rows = np.unique(self._parent_ids(cents.cpu().numpy(), k).ravel())
        refine_rows = refine_rows[refine_rows >= 0]
        self.refine_partitions(refine_rows.tolist(), p.refinement_iterations)

    def refine_partitions(self, rows, iterations: int):
        """Local Lloyd passes constrained to the given partitions
        (partition_manager.cpp:447-488, clustering.cpp:99-182): one batched
        pass over the gathered slabs on the index's device
        (kmeans.batched_refine), the host regrouping rows by the returned
        assignment; or with QUAKE_TPU_MAINT_HOST=1, and always on a spilled
        index, lloyd_refine_np over the partitions read one by one. On a
        spilled index twins that land in one cluster are separated
        (separate_twins) and each copy keeps its map (spill_flags)."""
        if not rows:
            return
        store = self.index.store
        R = len(rows)
        flags_list = None
        if not maint_on_host() and not self.index.spill:
            state = store.state
            rows_p = np.full(_bucket(R, 1), -1, np.int32)
            rows_p[:R] = [int(r) for r in rows]
            slabs, slab_ids, sizes, cents, assign = batched_refine(
                state.codes, state.ids, state.sizes, state.centroids,
                torch.from_numpy(rows_p).to(store.device), niter=max(iterations, 1),
                metric=self.index.metric)
            slabs = slabs[:R].cpu().numpy()
            slab_ids = slab_ids[:R].cpu().numpy().astype(np.int64)
            sizes = sizes[:R].cpu().numpy()
            new_cents = cents[:R].cpu().numpy()
            assign = assign[:R].cpu().numpy()
            # The pooled (vector, id, target slot) triples in slab order,
            # regrouped per target slot.
            fv = np.concatenate([slabs[i, :int(sizes[i])] for i in range(R)])
            fi = np.concatenate([slab_ids[i, :int(sizes[i])] for i in range(R)])
            fa = np.concatenate([assign[i, :int(sizes[i])] for i in range(R)])
            clusters = [(fv[fa == j], fi[fa == j]) for j in range(R)]
        else:
            parts = [store.get_partition(int(r)) for r in rows]
            cents = store.state.centroids[torch.as_tensor(rows, dtype=torch.long,
                                                          device=store.device)]
            new_cents, clusters = lloyd_refine_np(
                [v for v, _ in parts], [i for _, i in parts], cents.cpu().numpy(),
                self.index.metric, iterations)
            if self.index.spill:
                clusters = separate_twins(clusters, new_cents)
                flags_list = spill_flags(clusters, store.id_map, rows)
        store.write_partitions(list(rows), [c[0] for c in clusters],
                               [c[1] for c in clusters], new_cents, spill_flags_list=flags_list)
        self.index.parent.modify(np.asarray(rows, dtype=np.int64), new_cents)


def separate_twins(clusters, cents, chunk: int = 4096):
    """Twins (an id's two copies, the same vector) that Lloyd put in one
    cluster: the later occurrence moves to its nearest other centroid
    (cents, the refined ones). The result is that of the JAX package's loop
    (quake_tpu/maintenance/policy.py::refine_partitions), which moves copy by
    copy: each cluster keeps its other rows in order, followed by the rows
    moved into it, cluster by cluster in order and within a cluster from the
    last moved row to the first. Returns the clusters as (vecs, ids)."""
    m = len(clusters)
    kept, moved = [], [[] for _ in range(m)]
    for j, (v, i) in enumerate(clusters):
        v, i = np.asarray(v, np.float32), np.asarray(i, np.int64)
        first = np.zeros(len(i), bool)
        first[np.unique(i, return_index=True)[1]] = True
        kept.append((v[first], i[first]))
        pos = np.flatnonzero(~first)[::-1]
        for c0 in range(0, len(pos), chunk):
            p = pos[c0:c0 + chunk]
            d2 = ((cents[None, :, :] - v[p][:, None, :]) ** 2).sum(axis=2)
            d2[:, j] = np.inf
            for t, pp in zip(np.argmin(d2, axis=1), p):
                moved[t].append((v[pp], i[pp]))
    return [(np.concatenate([kv, np.stack([a for a, _ in mv])]) if mv else kv,
             np.concatenate([ki, np.asarray([b for _, b in mv], np.int64)]) if mv else ki)
            for (kv, ki), mv in zip(kept, moved)]


def spill_flags(clusters, id_map, rows):
    """Per written copy of a spilled refinement: True where it is the spill
    copy. An id pooled twice: its first occurrence in cluster order is the
    primary (the copies are the same vector); an id pooled once: the spill
    copy where its primary lives outside the refined rows."""
    row_set = np.asarray(sorted(int(r) for r in rows), np.int64)
    all_ids = np.concatenate([np.asarray(i, np.int64) for _, i in clusters])
    uniq, counts = np.unique(all_ids, return_counts=True)
    twice = np.isin(all_ids, uniq[counts > 1])
    first = np.zeros(len(all_ids), bool)
    first[np.unique(all_ids, return_index=True)[1]] = True
    outside = ~np.isin(id_map.get_batch(all_ids).astype(np.int64), row_set)
    flags = np.where(twice, ~first, outside)
    cuts = np.cumsum([len(i) for _, i in clusters])[:-1]
    return np.split(flags, cuts)
