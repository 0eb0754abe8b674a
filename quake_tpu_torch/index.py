"""QuakeIndex: build with APS calibration; the flat, the query-major, the
batched fixed-nprobe and the recall-target (APS) searches; add, remove,
modify, get and validate with split-on-overflow; cost-based maintenance (the
hit window fed by every search, the latency grid, splits, deletes and
refinement); save and load; each of them on a SOAR-spilled index too; and
sharding over a device mesh (`shard`, parallel/) (those parts of
quake_tpu/index.py).

A recursive IVF structure, as in the reference orchestrator
(src/cpp/include/quake_index.h:18-142, src/cpp/src/quake_index.cpp:29-288):
`parent` is a QuakeIndex over the partition centroids, flat by default, or
itself an IVF index with a parent of its own where
IndexBuildParams.parent_params asks for nlist > 1 (three levels or more).
The compute runs as PyTorch and CUDA launches over the padded partition
store on `device`; this class is the host-side control plane (validation, id
bookkeeping, recursion, persistence, timing).

Every feature of the JAX package is implemented; where this package
deviates from it on purpose, ROADMAP.md says so and a test pins it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from quake_tpu_torch import coordinator
from quake_tpu_torch.geometry import beta_table, effective_dimension
from quake_tpu_torch.kmeans import (balance_clusters, batched_two_means, kmeans_fit_assign,
                                     kmeans_np, soar_assign)
from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator
from quake_tpu_torch.maintenance.policy import MaintenancePolicy, maint_on_host
from quake_tpu_torch.ops.grouped import QTS, grouped_scan_xla
from quake_tpu_torch.ops.grouped_scan import grouped_scan_uses_mma
from quake_tpu_torch.ops.scan import dedup_topk, scores_to_distances
from quake_tpu_torch.parallel.mesh import make_mesh, shard_store_state
from quake_tpu_torch.parallel.sharded import (sharded_aps_search, sharded_aps_search_oneshot,
                                              sharded_aps_search_planned, sharded_flat_search,
                                              sharded_fused_search, sharded_ivf_search)
from quake_tpu_torch.params import (DEFAULT_INITIAL_SEARCH_FRACTION, IndexBuildParams,
                                     MaintenancePolicyParams, SearchParams, check_metric)
from quake_tpu_torch.profiling import annotate
from quake_tpu_torch.storage.store import PartitionStore, StoreState, _bucket, _sumsq
from quake_tpu_torch.timing import (BuildTimingInfo, MaintenanceTimingInfo, ModifyTimingInfo,
                                    SearchResult, SearchTimingInfo)
from quake_tpu_torch.utils import compute_recall, next_pow2, to_f32, to_i64

INT32_MAX = np.iinfo(np.int32).max
MIN_BATCH = 16  # smaller batches take the query-major path
SERIALIZATION_VERSION = 1  # the JAX package's save format (quake_tpu/index.py:47)

CODE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}  # IndexBuildParams.precision

# The APS calibration an index carries and a save keeps
# (quake_tpu/index.py:1831-1840), with the JAX package's defaults
# (calibrate_aps sets them; see the JAX package's __init__ for each).
APS_FIELDS = dict(aps_gamma=1.0, aps_radius_ab=None, aps_oneshot_mcap=0, aps_budget_w=0,
                  aps_width_clip=0, aps_calib_target=0.0, aps_dense_w=0, aps_calib_nq=0,
                  aps_plan_width=0)


def _now_us() -> int:
    return int(time.perf_counter() * 1e6)


def _now_ns() -> int:
    return int(time.perf_counter() * 1e9)


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("QuakeIndex(device=None) runs on CUDA, and no CUDA "
                               "device is available; pass device='cpu' to use the "
                               "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def _recall_without_self(ids32: torch.Tensor, self_ids: np.ndarray, gt: np.ndarray,
                         k: int) -> float:
    """Recall@k of a [nq, k+1] search result against gt, each row's own id
    dropped (the calibration protocol)."""
    return compute_recall(_drop_self(ids32.cpu().numpy().astype(np.int64), self_ids, k), gt, k)


def _drop_self(ids: np.ndarray, self_ids: np.ndarray, k: int) -> np.ndarray:
    """Remove each row's own id from a [nq, k+1] neighbor list, keeping k
    (quake_tpu/index.py::_drop_self): calibration queries come from resident
    vectors, whose own id would be a free home-partition hit."""
    out = np.empty((ids.shape[0], k), dtype=ids.dtype)
    for i, row in enumerate(ids):
        keep = row[row != self_ids[i]]
        if keep.shape[0] < k:  # self id absent: drop the tail instead
            keep = row[:k]
        out[i] = keep[:k]
    return out


class QuakeIndex:
    """Dynamic IVF index: build, flat, fixed-nprobe and recall-target
    search, mutation, cost-based maintenance and persistence.

    Every IVF index carries a maintenance policy (`maintenance_policy`, set
    at the end of build and load, as in the JAX package): each search
    records its probed partitions into the policy's hit window as device
    tensors (no host read, no copy), and `maintenance()` splits hot
    partitions, deletes cold ones and refines the neighbourhood of the
    splits. `latency_profile` is the latency grid the policy's cost model
    reads: None (the default grid: the packaged H100 grid on a CUDA index,
    the analytic model on a CPU one), profiled at build
    (profile_maintenance_latency=True: the index's grouped scan timed over
    the grid, on a CUDA index kernels K1 and K2 in device time) or loaded
    from latency_profile.csv. The hit window is not saved. A parent that
    is itself an IVF index has a policy of its own.

    `mesh` (None until `shard`) is the device mesh the store is sharded
    over (parallel/): the searches then run each shard's scans and merge
    on the mesh's first device, while the global store stays the one
    primary copy that mutation, maintenance, validate and save use; the
    shards are rebuilt from it after any write."""

    def __init__(self, level: int = 0, device=None):
        self.level = level
        self.device = resolve_device(device)
        self.metric: str = "l2"
        self.store: Optional[PartitionStore] = None
        self.parent: Optional["QuakeIndex"] = None
        self.build_params: Optional[IndexBuildParams] = None
        self.aps_dimension = 0  # effective dimension for the APS recall model
        for name, default in APS_FIELDS.items():
            setattr(self, name, default)
        self.spill = False  # SOAR spill (IndexBuildParams.spill): every vector stored twice
        self.soar_lambda = 1.0
        self.maintenance_policy: Optional[MaintenancePolicy] = None  # IVF only
        self.latency_profile: Optional[ListScanLatencyEstimator] = None  # else analytic
        self._nprobe_bucket = 8  # pow2 padding for probe lists
        self.mesh = None  # the device mesh once sharded (num_shards > 1, shard())
        self._sharded = None  # ShardedState of the store's version _sharded_version
        self._sharded_version = -1
        # Mutation coalescing buffer (IndexBuildParams.mutation_buffer_size).
        self._pending_x: list = []
        self._pending_vids: list = []
        self._pending_idset: set = set()

    # ------------------------------------------------------------------ build

    def _would_shard(self, n_workers: int) -> bool:
        """Whether the JAX package would shard over n_workers devices
        (quake_tpu/index.py:216-218, :1956): only where there are that many.
        A CPU index counts as one device."""
        return (n_workers > 1 and self.device.type == "cuda"
                and torch.cuda.device_count() >= n_workers)

    def _shard_plan(self, bp: IndexBuildParams) -> int:
        """The shard count a build plans (quake_tpu/index.py:211-221,
        :248-254): num_shards, else num_workers where the JAX package would
        shard over them (_would_shard); <= 1 builds unsharded."""
        n = bp.num_shards
        if n <= 1 and self._would_shard(bp.num_workers):
            n = bp.num_workers
        return n

    def _check_build_params(self, bp: IndexBuildParams, n: int) -> None:
        if bp.precision not in CODE_DTYPES:
            raise ValueError(f"precision must be one of {list(CODE_DTYPES)}, not "
                             f"{bp.precision!r}")

    def build(self, x, ids=None, build_params: Optional[IndexBuildParams] = None) -> BuildTimingInfo:
        """Build the index (quake_index.cpp:29-90). The top level's build
        runs in the span quake.build, its stages in quake.build.kmeans,
        .balance, .fill (the store), .parent and .calibrate; a parent's own
        build opens none of its own."""
        span = annotate if self.level == 0 else (lambda name: contextlib.nullcontext())
        with span("quake.build"):
            return self._build(x, ids, build_params, span)

    def _build(self, x, ids, build_params, span) -> BuildTimingInfo:
        t0 = _now_us()
        bp = build_params or IndexBuildParams()
        self.metric = check_metric(bp.metric)
        x = to_f32(x)
        n, d = x.shape
        self._check_build_params(bp, n)
        self.build_params = bp
        self.mesh, self._sharded = None, None
        n_shards = self._shard_plan(bp)
        if bp.dimension and bp.dimension != d:
            raise ValueError(f"dimension mismatch: params say {bp.dimension}, data is {d}")
        bp.dimension = d
        ids = np.arange(n, dtype=np.int64) if ids is None else to_i64(ids)
        if ids.shape[0] != n:
            raise ValueError("ids length must match number of vectors")
        self._validate_new_ids(ids, check_resident=False)

        self.store = PartitionStore(d, self.device, dtype=CODE_DTYPES[bp.precision])
        timing = BuildTimingInfo(n_vectors=n, n_clusters=max(bp.nlist, 1), d=d)
        if bp.nlist > 1:
            self.aps_dimension = effective_dimension(x)
            t_train = _now_us()
            with span("quake.build.kmeans"):
                centroids, assignments = kmeans_fit_assign(
                    torch.from_numpy(x).to(self.device), bp.nlist, metric=self.metric,
                    niter=bp.niter)
                centroids_np = centroids.cpu().numpy()
                assigns_np = assignments.cpu().numpy()
            if bp.balance_partitions:
                # Bound slab padding: split clusters above balance_factor x
                # the mean (see kmeans.balance_clusters).
                t_balance = _now_us()
                with span("quake.build.balance"):
                    mean = max(n // max(bp.nlist, 1), 1)
                    cap = max(256, -(-int(bp.balance_factor * mean) // 128) * 128)
                    centroids_np, assigns_np = balance_clusters(x, centroids_np, assigns_np, cap,
                                                                metric=self.metric)
                timing.balance_time_us = _now_us() - t_balance
            nlist_final = centroids_np.shape[0]
            timing.train_time_us = _now_us() - t_train
            timing.n_clusters = nlist_final

            t_assign = _now_us()
            with span("quake.build.fill"):
                spill_np = None
                if bp.spill:
                    # SOAR: a second partition per vector against the final
                    # (balanced) centroids, the balanced primary kept.
                    self.spill = True
                    self.soar_lambda = float(bp.soar_lambda)
                    _, spill_np = soar_assign(x, centroids_np, self.soar_lambda,
                                              primary=assigns_np, device=self.device)
                # Slot sharding splits C: the plan's 128 * shards rounding keeps
                # each shard's slice a multiple of the kernels' fold.
                self.store.init_from_assignments(x, ids, centroids_np, assigns_np,
                                                 spill_assignments=spill_np,
                                                 cap_multiple=128 * max(n_shards, 1))
            timing.assign_time_us = _now_us() - t_assign

            # Recursive parent over the centroids (quake_index.cpp:57-61):
            # flat, or an IVF index at the next level where parent_params
            # asks for one, with its own parent, store and policy.
            with span("quake.build.parent"):
                parent_bp = bp.parent_params or IndexBuildParams(metric=bp.metric, nlist=0)
                parent_bp.metric = bp.metric
                self.parent = QuakeIndex(level=self.level + 1, device=self.device)
                self.parent.build(centroids_np, np.arange(nlist_final, dtype=np.int64),
                                  parent_bp)
        else:
            # Flat: one partition holding everything (quake_index.cpp:68-79).
            if bp.spill:
                raise ValueError("spill requires an IVF index (nlist > 1)")
            self.store.init_single_partition(x, ids)
        # A spilled store skips calibration, as in the JAX package: its flat
        # ground truth would hold each id twice.
        if bp.nlist > 1 and bp.calibrate_aps and n >= 10_000 and not bp.spill:
            t_cal = _now_us()
            with span("quake.build.calibrate"):
                self.calibrate_aps()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            timing.calibrate_time_us = _now_us() - t_cal
        # The reference spawns num_workers scan workers at build
        # (quake_index.cpp:85); a worker here is a mesh shard.
        if n_shards > 1:
            self.shard(n_shards)
        if bp.profile_maintenance_latency:
            self.profile_latency()
        self.initialize_maintenance_policy(MaintenancePolicyParams())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing.total_time_us = _now_us() - t0
        return timing

    def profile_latency(self, n_values=None, k_values=None) -> ListScanLatencyEstimator:
        """Time this index's grouped scan over the (n, k) grid and give the
        grid to the maintenance cost model (quake_index.cpp:81-82 ->
        maintenance_cost_estimator.cpp:59-94): on a CUDA index the scan
        _grouped_kernel names (v11: kernels K1 and K2) at K1's query tile for
        this D, on a CPU index "xla", as the JAX package profiles off a TPU.
        save() writes it to latency_profile.csv, load() reads it back."""
        est = ListScanLatencyEstimator(self.d(), n_values=n_values, k_values=k_values)
        if self.device.type == "cuda":
            est.profile_grouped_latency(kernel=self._grouped_kernel(), qt=self._k1_qt(32),
                                        device=self.device)
        else:
            est.profile_grouped_latency(kernel="xla", device=self.device)
        self.latency_profile = est
        if self.maintenance_policy is not None:
            self.maintenance_policy.cost_estimator.latency_estimator = est
        return est

    def shard(self, n_devices: int, devices=None) -> None:
        """Shard the partition store over a device mesh (quake_tpu/index.py::
        shard; the reference's worker-pool initialization,
        query_coordinator.cpp:50-73): make_mesh(n_devices, devices) on this
        index's device type, then C re-bucketed to a multiple of 128 *
        shards (each shard's slot slice a multiple of the kernels' fold, as
        later growth keeps it) and the slot-sharded state built. `devices`,
        an explicit list that may repeat a device (four shards on one card:
        [cuda:0] * 4), is this package's addition. A CUDA index's mesh holds
        CUDA devices only, a CPU index's the CPU only: no shard falls back
        to another device type."""
        mesh = make_mesh(n_devices, devices, device=self.device)
        other = [str(d) for d in mesh.devices if d.type != self.device.type]
        if other:
            raise ValueError(f"a {self.device.type} index cannot shard onto {other}")
        self.mesh, self._sharded = mesh, None
        self.store.ensure_capacity_multiple(128 * mesh.size)
        self._shards()

    def _shards(self):
        """The store's ShardedState (the slot strategy, as the JAX package's
        shard() places it), rebuilt from the primary
        copy where the store has been written since it was built
        (PartitionStore.version). A write that grew C past the multiple of
        128 * shards (write_partitions' unrounded growth) is re-bucketed
        first."""
        store = self.store
        store.ensure_capacity_multiple(128 * self.mesh.size)
        if self._sharded is None or self._sharded_version != store.version:
            self._sharded = None  # the old copies go before the new ones are made
            self._sharded = shard_store_state(store.state, self.mesh)
            self._sharded_version = store.version
        return self._sharded

    def initialize_maintenance_policy(self, params: MaintenancePolicyParams) -> None:
        """A fresh policy with an empty window (quake_index.cpp:148-155); only
        an IVF index (one with a parent) gets one."""
        if self.parent is not None:
            self.maintenance_policy = MaintenancePolicy(self, params)

    def _record_hits(self, pids: torch.Tensor, scanned: torch.Tensor) -> None:
        """Feed the maintenance hit window with a search's ranked probe lists
        and per-query scanned counts, as the device tensors they are (the
        reference's unwired record_query_hits, wired as in the JAX
        package)."""
        if self.maintenance_policy is not None:
            with annotate("quake.plan.hits"):
                self.maintenance_policy.record_query_hits_device(pids, scanned)

    # ----------------------------------------------------------------- search

    def search(self, x, search_params: Optional[SearchParams] = None) -> SearchResult:
        """Top-k search (quake_index.cpp:93-99, query_coordinator.cpp:612-657).

        Timing phases:
          buffer_init      = query validation + host->device copy
          job_enqueue      = enqueueing the search's launches
          job_wait         = device execution + the id copy back to the host
          result_aggregate = the distance copy and conversion
        each a span inside the span quake.search (profiling.annotate:
        quake.buffer_init, quake.dispatch, quake.device_wait,
        quake.aggregate).
        """
        with annotate("quake.search"):
            t0 = _now_ns()
            sp = search_params or SearchParams()
            with annotate("quake.buffer_init"):
                self._flush_mutations()
                x = to_f32(x)
                if x.ndim == 1:
                    x = x[None, :]
                if x.shape[1] != self.d():
                    raise ValueError(f"query dimension {x.shape[1]} != index dimension "
                                     f"{self.d()}")
                q = torch.from_numpy(x).to(self.device)
            t1 = _now_ns()
            with annotate("quake.dispatch"):
                _, ids32, timing, dists = self._search_device_full(q, sp)
            t2 = _now_ns()
            with annotate("quake.device_wait"):
                ids_np = ids32.cpu().numpy().astype(np.int64)  # waits for the device
            t3 = _now_ns()
            with annotate("quake.aggregate"):
                scanned_dev = getattr(timing, "_scanned_dev", None)
                if scanned_dev is not None:  # APS: read after the wait above
                    sc = scanned_dev.cpu().numpy().astype(np.int32, copy=False)
                    timing.scanned_per_query = sc
                    timing.partitions_scanned = int(sc.mean()) if sc.size else 0
                    timing._scanned_dev = None
                dists_np = dists.cpu().numpy()
            t4 = _now_ns()
        timing.buffer_init_time_ns = t1 - t0
        timing.job_enqueue_time_ns = t2 - t1
        timing.job_wait_time_ns = t3 - t2
        timing.result_aggregate_time_ns = t4 - t3
        timing.total_time_ns = t4 - t0
        return SearchResult(ids=ids_np, distances=dists_np, timing_info=timing)

    def _search_device_full(self, q: torch.Tensor, sp: SearchParams):
        """Search of a [B, D] f32 tensor on the index's device; returns
        (scores, ids32, timing, distances) as device tensors, with the
        launches enqueued and not waited for. Batches of at least 16 queries
        over a flat parent take the fused partition-major path unless
        batched_scan is False (a spilled index takes it whatever
        batched_scan says, with the dedup tail); a flat index scans every
        slot; the rest, and every search of an index whose parent is itself
        an IVF (quake_tpu/index.py:855-860), goes through _search_device.
        exact_distances=False dequantizes the scores of the fused path's and
        the APS scans' v10/v11; the flat and query-major searches, and every
        other scan, stay exact, as in the JAX package. On a mesh the fused
        path is sharded_fused_search over the slot shards (its parents
        ranked by the flat scan, not kernel K3), and a sharded flat index
        goes through _search_device. The index shards by slot only (shard),
        so the JAX package's fallback for a partition-sharded store
        (quake_tpu/index.py:875-877) has nothing to route.

        A recall target (APS) in aps_mode "auto" or "dense" first tries the
        calibrated dense prefix (_aps_dense_route); otherwise _search_device
        runs the per-query plans."""
        B = int(q.shape[0])
        k = max(int(sp.k), 1)
        use_aps = sp.recall_target > 0.0 and self.parent is not None
        if use_aps and sp.aps_mode in ("auto", "dense"):
            routed = self._aps_dense_route(q, sp)
            if routed is not None:
                return routed
        if self.parent is None and self.mesh is None:
            # Flat exact mode (quake_index.cpp:68-79).
            timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
            state = self.store.state
            scores, ids32, dists = coordinator.fused_flat_search(state.codes, state.ids, q, k,
                                                                 self.metric)
            timing.partitions_scanned = self.nlist()
            return scores, ids32, timing, dists
        if (self.parent is None or use_aps or B < MIN_BATCH
                or (sp.batched_scan is False and not self.spill)
                or self.parent.parent is not None):
            scores, ids32, timing = self._search_device(q, sp)
            return scores, ids32, timing, scores_to_distances(scores, ids32, self.metric)
        timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
        parent_k = min(int(sp.nprobe), self.nlist())
        qt, group_chunk = self._grouped_params(B, parent_k)
        pstate = self.parent.store.state
        if self.mesh is not None:
            scores, ids32, dists, scanned, pids = sharded_fused_search(
                self._shards(), pstate.codes, pstate.ids, q, k=k, nprobe=parent_k,
                metric=self.metric, qt=qt, group_chunk=group_chunk, dedup=self.spill,
                kernel=self._grouped_kernel(), exact=bool(sp.exact_distances))
        else:
            state = self.store.state
            scores, ids32, dists, scanned, pids = coordinator.fused_ivf_search(
                state.codes, state.ids, state.sizes, state.norms,
                pstate.codes, pstate.ids, q, k=k, nprobe=parent_k, metric=self.metric,
                qt=qt, kernel=self._grouped_kernel(), parent_norms=pstate.norms,
                group_chunk=group_chunk, parent_kernel=self._parent_kernel(),
                exact=bool(sp.exact_distances), dedup=self.spill)
        timing.partitions_scanned = parent_k
        timing.parent_info = SearchTimingInfo(
            n_queries=B, n_clusters=self.parent.nlist(),
            partitions_scanned=self.parent.nlist())
        self._record_hits(pids, scanned)
        return scores, ids32, timing, dists

    def _aps_dense_route(self, q: torch.Tensor, sp: SearchParams):
        """The dense-prefix routes of recall-target search
        (quake_tpu/index.py:801-854): where calibration validated a width
        (aps_dense_w, else aps_width_clip) for a target at least the
        requested one, and the candidate width is auto
        (initial_search_fraction None), the fixed-nprobe search at that
        width; in auto mode with a budget calibrated, a target above the
        calibrated one scans the widest calibrated reach (aps_width_clip)
        densely. Returns _search_device_full's tuple, or None to go on to
        the per-query plans; aps_mode="dense" without a route raises
        ValueError."""
        width = int(self.aps_dense_w or 0) or int(self.aps_width_clip or 0)
        calib_t = float(self.aps_calib_target or 0.0)
        npb = 0
        if (width and sp.initial_search_fraction is None
                and float(sp.recall_target) <= calib_t + 1e-6):
            npb = min(width, self.nlist())
        elif (sp.aps_mode == "auto" and self.aps_width_clip
              and sp.initial_search_fraction is None and self.aps_radius_ab is not None):
            npb = min(int(self.aps_width_clip), self.nlist())
        if npb:
            sp_fixed = dataclasses.replace(sp, recall_target=0.0, nprobe=npb, aps_mode="auto")
            scores, ids32, timing, dists = self._search_device_full(q, sp_fixed)
            timing.search_params = sp
            timing.partitions_scanned = npb
            return scores, ids32, timing, dists
        if sp.aps_mode == "dense":
            raise ValueError(
                "aps_mode='dense' requires a calibrated width "
                f"(aps_dense_w={self.aps_dense_w}, aps_width_clip={self.aps_width_clip}), auto "
                "candidate sizing (initial_search_fraction=None), and "
                f"recall_target <= {calib_t} (the calibrated target); run "
                "calibrate_aps(target=...) or use aps_mode='auto'.")
        return None

    def _search_device(self, q: torch.Tensor, sp: SearchParams, approx_flat: bool = False):
        """The unfused search (quake_tpu/index.py::_search_device); returns
        (scores, int32 ids, timing). A flat index scans every slot (on a
        mesh each shard its slots, merged); approx_flat marks a parent
        centroid ranking (see ops/scan.py::topk_from_scores), user-facing
        flat searches stay exact. An IVF index ranks candidates through its
        parent, padded to a power of two of at least the nprobe bucket and
        trimmed back, then scans partition-major in tensor operations
        (batched_scan true, or unset with at least 16 queries; a spilled
        index always, for the dedup merge) or query-major, and on a mesh
        each shard query-major over its slices (sharded_ivf_search); with a
        recall target, it runs an APS strategy over the candidates
        (_aps_search; the oneshot one ranks the parents itself where the
        parent is flat, except on a spilled or sharded index). A parent that
        is itself an IVF is searched by this same method, recursively, with
        the caller's nprobe and the boosted recall target below, and records
        its own hit window."""
        B = int(q.shape[0])
        timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
        k = max(int(sp.k), 1)
        state = self.store.state
        if self.parent is None:
            if self.mesh is not None:
                scores, ids32 = sharded_flat_search(self._shards(), q, k, self.metric)
            else:
                scores, ids32 = coordinator.flat_search(state.codes, state.ids, q, k,
                                                        self.metric, approx=approx_flat)
            timing.partitions_scanned = self.nlist()
            return scores, ids32, timing
        # Parent search for candidate partitions (query_coordinator.cpp:628-646).
        use_aps = sp.recall_target > 0.0
        if use_aps:
            aps_mode, parent_k = self._aps_mode_and_width(B, k, sp)
        else:
            parent_k = min(int(sp.nprobe), self.nlist())
        parent_k_padded = min(next_pow2(parent_k, self._nprobe_bucket), self.parent.ntotal())
        # The caller's search parameters reach the parent as in the JAX
        # package (query_coordinator.cpp:628-634), a positive recall target
        # raised to min(0.99, sqrt(target)): ranking errors compound down the
        # levels. Nothing reads them while the parent is flat.
        parent_target = (min(0.99, float(sp.recall_target) ** 0.5) if sp.recall_target > 0
                         else sp.recall_target)
        parent_sp = SearchParams(k=parent_k_padded, batched_scan=True, nprobe=sp.nprobe,
                                 recall_target=parent_target,
                                 use_precomputed=sp.use_precomputed,
                                 recompute_threshold=sp.recompute_threshold,
                                 initial_search_fraction=sp.initial_search_fraction)
        if (use_aps and aps_mode == "oneshot" and not self.spill and self.parent.parent is None
                and self.mesh is None):
            # Fused oneshot: the parent ranking runs inside the oneshot call
            # (a flat parent and no mesh only, as in the JAX package).
            timing.parent_info = SearchTimingInfo(
                n_queries=B, n_clusters=self.parent.nlist(),
                partitions_scanned=self.parent.nlist())
            return (*self._aps_search(q, sp, timing, aps_mode, parent_k, None), timing)
        t1 = _now_ns()
        _, p_ids32, p_timing = self.parent._search_device(q, parent_sp, approx_flat=True)
        p_timing.total_time_ns = _now_ns() - t1  # enqueue; the device runs on
        timing.parent_info = p_timing
        pids = p_ids32[:, :parent_k]  # trim the padding back to the candidate count
        if use_aps:
            return (*self._aps_search(q, sp, timing, aps_mode, parent_k, pids), timing)
        if self.mesh is not None:
            scores, ids32, scanned = sharded_ivf_search(self._shards(), q, pids, k, self.metric,
                                                        dedup=self.spill)
        elif sp.batched_scan or self.spill or (sp.batched_scan is None and B >= MIN_BATCH):
            qt, group_chunk = self._grouped_params(B, parent_k)
            scores, ids32, scanned = grouped_scan_xla(state.codes, state.ids, q, pids, k,
                                                      self.metric, qt=qt,
                                                      group_chunk=group_chunk, dedup=self.spill)
        else:
            scores, ids32, scanned = coordinator.ivf_search(state.codes, state.ids, q, pids, k,
                                                            self.metric)
        timing.partitions_scanned = parent_k
        self._record_hits(pids, scanned)
        return scores, ids32, timing

    def _aps_mode_and_width(self, B: int, k: int, sp: SearchParams):
        """(APS strategy, candidate width parent_k) of a recall-target search
        (quake_tpu/index.py:1107-1180). "auto": oneshot at B >= 1024 where
        the radius predictor is calibrated, else planned (never the loop);
        oneshot without a predictor runs planned. The candidate width: the
        calibrated serving width (aps_oneshot_mcap for oneshot, else
        aps_plan_width; the reference fraction with a floor of 16 where
        uncalibrated) when initial_search_fraction is None, else nlist times
        the fraction (capped at mcap for oneshot); never below the
        partitions that can hold 2k results."""
        aps_mode = sp.aps_mode
        if aps_mode == "auto":
            aps_mode = ("oneshot" if B >= 1024 and self.aps_radius_ab is not None
                        else "planned")
        if aps_mode == "oneshot" and self.aps_radius_ab is None:
            aps_mode = "planned"
        nlist = self.nlist()
        avg_sz = max(self.ntotal() / max(nlist, 1), 1.0)
        min_parts = min(int(np.ceil(2.0 * k / avg_sz)), nlist)
        mcap = int(self.aps_oneshot_mcap or 0)
        if sp.initial_search_fraction is None:
            width = int(self.aps_plan_width or 0)
            if aps_mode == "oneshot" and mcap:
                width = mcap
            if not width:
                width = max(int(nlist * DEFAULT_INITIAL_SEARCH_FRACTION), min(nlist, 16))
            parent_k = max(min(width, nlist), min_parts, 1)
        else:
            parent_k = max(int(nlist * float(sp.initial_search_fraction)), min_parts, 1)
            if aps_mode == "oneshot" and mcap:
                parent_k = max(min(parent_k, mcap), min_parts, 1)
        return aps_mode, parent_k

    def _aps_search(self, q, sp: SearchParams, timing, mode: str, parent_k: int, pids):
        """The APS half of quake_tpu/index.py::_search_device (:1223-1413):
        oneshot (its parents ranked inside where pids is None, never on a
        mesh), planned or the loop, with the calibrated dimension, gamma,
        radius model and budget; on a mesh their sharded versions
        (parallel/sharded.py), each scan the shards' local scans merged on
        the mesh's first device. A spilled index scans at 2k and keeps each id's
        best entry after (dedup_topk): a merge can carry both copies of a
        neighbour, and the 2k-th distance keeps the recall model
        conservative. `scanned` stays on the device as timing._scanned_dev
        (search() reads it after its wait, into scanned_per_query and
        partitions_scanned); the plan's pair budget (aps_pair_budget) and
        the loop's steps and syncs go to timing. Returns (scores, ids32)."""
        B = int(q.shape[0])
        k_out = max(int(sp.k), 1)
        k = 2 * k_out if self.spill else k_out
        state = self.store.state
        t_b = _now_ns()
        table = (beta_table(self.aps_dimension or self.d(), "l2", self.device)
                 if sp.use_precomputed else None)
        timing.boundary_distance_time_ns = _now_ns() - t_b
        chunk = int(sp.aps_chunk_size)
        if chunk <= 0:  # auto: two coarse steps at batch, 8 ranks a step below it
            chunk = max(8, -(-parent_k // 2)) if B >= 1024 else 8
        qt, group_chunk = self._grouped_params(B, chunk)
        common = dict(k=k, metric=self.metric, dimension=self.aps_dimension or self.d(),
                      use_precomputed=bool(sp.use_precomputed), table=table, qt=qt,
                      kernel=self._grouped_kernel(),
                      gamma=self.aps_gamma if self.aps_gamma != 1.0 else None,
                      exact=bool(sp.exact_distances))
        if self.mesh is None:
            lead = (state.codes, state.ids, state.centroids)
            oneshot, planned, loop = (coordinator.aps_search_oneshot,
                                      coordinator.aps_search_planned, coordinator.aps_search)
            common.update(sizes=state.sizes, norms=state.norms)
        else:  # the shards' local scans merged on the mesh's first device
            lead = (self._shards(),)
            oneshot, planned, loop = (sharded_aps_search_oneshot, sharded_aps_search_planned,
                                      sharded_aps_search)
            common.update(group_chunk=group_chunk)
        plans = dict(plan_margin=int(sp.aps_plan_margin), width_clip=int(self.aps_width_clip),
                     budget_w=int(self.aps_budget_w))
        target = float(sp.recall_target)
        if mode == "oneshot" and pids is None:
            ra, rb = self._radius_coef(k)
            pstate = self.parent.store.state
            scores, ids32, scanned, pids = coordinator.aps_search_oneshot_fused(
                state.codes, state.ids, state.centroids, pstate.codes, pstate.ids,
                pstate.norms, q, target,
                parent_k=int(parent_k), mcap=int(self.aps_oneshot_mcap or 0), radius_a=ra,
                radius_b=rb, parent_kernel=self._parent_kernel(), **common, **plans)
        elif mode == "oneshot":
            ra, rb = self._radius_coef(k)
            mcap = int(self.aps_oneshot_mcap or 0)
            scores, ids32, scanned = oneshot(
                *lead, q, pids[:, :mcap] if mcap and pids.shape[1] > mcap else pids, target,
                radius_a=ra, radius_b=rb, **common, **plans)
        elif mode == "planned":
            chunk0 = (int(sp.aps_chunk_size) if sp.aps_chunk_size > 0
                      else self._planned_chunk0(parent_k))
            scores, ids32, scanned = planned(*lead, q, pids, target, chunk0=chunk0, **common,
                                             **plans)
        else:
            stats = {}
            scores, ids32, scanned = loop(*lead, q, pids, target, float(sp.recompute_threshold),
                                          chunk=chunk, stats=stats, **common)
            timing.aps_loop_steps = stats["steps"]
            timing.aps_loop_syncs = stats["syncs"]
        if mode != "loop" and self.aps_width_clip and self.aps_budget_w:
            # The plan's pair budget, a host int (coordinator.aps_oneshot, aps_plan).
            timing.aps_pair_budget = B * max(int(self.aps_budget_w), 4)
        if self.spill:
            scores, ids32 = dedup_topk(scores, ids32, k_out)
        # Kept on the device: reading the mean here would wait for the search.
        timing._scanned_dev = scanned
        self._record_hits(pids, scanned)
        return scores, ids32

    def _radius_coef(self, k: int):
        """(a, b) of the calibrated oneshot radius model for this k; k past
        the calibrated kmax clamps to the last row."""
        ab = self.aps_radius_ab
        row = min(max(int(k), 1), ab.shape[0]) - 1
        return float(ab[row, 0]), float(ab[row, 1])

    def _planned_chunk0(self, parent_k: int) -> int:
        """Prologue rank count of planned APS: 8 (the JAX package's measured
        choice, quake_tpu/index.py:1022-1038), at most the candidate width."""
        return min(8, max(parent_k, 1))

    # ------------------------------------------------------ APS calibration

    def calibrate_aps(self, target: float = 0.9, nq: int = 0, k: int = 10):
        """Calibrate the APS recall model against realized recall
        (quake_tpu/index.py::calibrate_aps, step for step): every product
        of an earlier calibration reset first; pseudo-out-of-sample queries
        (resident vectors moved by their exact k-th-neighbor radius in a
        random direction, numpy seed 0) with exact ground truth; the model
        dimension swept from a quarter of the intrinsic dimension to the
        ambient one (twice it for ip), the candidate width escalating over
        0.25, 0.5 and all of nlist; the sharpening gamma; the plan width;
        then _calibrate_radius_predictor. Each trial is a search of the
        index's own scan (`_grouped_kernel`). nq=0 sizes the sample
        max(128, min(768, 2 nlist)), at most ntotal / 4; fewer than 512
        vectors leave APS uncalibrated."""
        for name, default in APS_FIELDS.items():
            setattr(self, name, default)
        if self.parent is None or self.ntotal() < 512:
            return
        if nq <= 0:
            nq = max(128, min(768, 2 * self.nlist()))
        nq = min(nq, self.ntotal() // 4)
        sample_ids = self.store.get_ids()[:nq]
        q_np, found = self.store.get_vectors(sample_ids)
        q0_np = np.ascontiguousarray(q_np[found], dtype=np.float32)
        self_ids = np.asarray(sample_ids)[found].astype(np.int64)
        if q0_np.shape[0] < 8:
            return
        state = self.store.state
        dev = self.device
        # Pseudo-OOS queries: each sample moved by its exact rank-k distance
        # (rank 0 is the self match), unit-norm again for ip.
        sc0, _ = coordinator.flat_search(state.codes, state.ids, torch.from_numpy(q0_np).to(dev),
                                         k + 1, self.metric)
        kth0 = sc0.cpu().numpy().astype(np.float32)[:, k]
        if self.metric == "l2":
            r_k = np.sqrt(np.maximum(-kth0, 0.0))
        else:
            r_k = np.sqrt(np.maximum(np.sum(q0_np ** 2, axis=1) + 1.0 - 2.0 * kth0, 0.0))
        gdir = np.random.default_rng(0).standard_normal(q0_np.shape).astype(np.float32)
        gdir /= np.maximum(np.linalg.norm(gdir, axis=1, keepdims=True), 1e-9)
        q_pert = q0_np + r_k[:, None] * gdir
        if self.metric == "ip":
            q_pert /= np.maximum(np.linalg.norm(q_pert, axis=1, keepdims=True), 1e-9)
        q = torch.from_numpy(np.ascontiguousarray(q_pert, dtype=np.float32)).to(dev)
        _, gt32 = coordinator.flat_search(state.codes, state.ids, q, k + 1, self.metric)
        gt = _drop_self(gt32.cpu().numpy().astype(np.int64), self_ids, k)

        d_lo = max((self.aps_dimension or self.d()) // 4, 2)
        d_hi = max(self.d(), d_lo + 1)
        margin = 0.02
        if self.metric == "ip":  # sweep above ambient, trim the margin
            d_hi = max(2 * self.d(), d_lo + 1)
            margin = 0.005
        cands = np.unique(np.round(np.geomspace(d_lo, d_hi, 8)).astype(int))[::-1]
        goal = min(target + margin, 0.995)
        chosen = int(cands[-1])
        acc_scanned = None
        seen_w = set()
        scan = dict(k=k + 1, metric=self.metric, dimension=self.d(), chunk=4,
                    use_precomputed=True, kernel=self._grouped_kernel(), sizes=state.sizes,
                    norms=state.norms)
        for frac_c in (0.25, 0.5, 1.0):
            parent_k = max(int(self.nlist() * frac_c), 1)
            if parent_k in seen_w:
                continue
            seen_w.add(parent_k)
            parent_k_padded = min(next_pow2(parent_k, self._nprobe_bucket),
                                  self.parent_ntotal())
            _, p_ids32, _ = self.parent._search_device(
                q, SearchParams(k=parent_k_padded, batched_scan=True))
            pids = p_ids32[:, :parent_k] if parent_k < p_ids32.shape[1] else p_ids32
            for d_cand in cands:
                _, ids32, scanned = coordinator.aps_search(
                    state.codes, state.ids, state.centroids, q, pids, float(target), 0.0,
                    table=beta_table(int(d_cand), "l2", dev), **scan)
                if _recall_without_self(ids32, self_ids, gt, k) >= goal:
                    chosen = int(d_cand)
                    acc_scanned = scanned.cpu().numpy()
                    break
            if acc_scanned is not None:
                break
        self.aps_dimension = chosen

        # The profile-sharpening exponent: the largest that still meets the goal.
        self.aps_gamma = 1.0
        table = beta_table(chosen, "l2", dev)
        for g_cand in (1.5, 2.0, 3.0, 4.0, 6.0):
            _, ids32, scanned_g = coordinator.aps_search(
                state.codes, state.ids, state.centroids, q, pids, float(target), 0.0,
                table=table, gamma=g_cand, **scan)
            if _recall_without_self(ids32, self_ids, gt, k) < goal:
                break
            self.aps_gamma = float(g_cand)
            acc_scanned = scanned_g.cpu().numpy()

        # Serving width: p99 of the accepted plans' depths, 1.5x, rounded up
        # to 8, within [8, the calibration width].
        if acc_scanned is not None:
            need = float(np.quantile(acc_scanned.astype(np.float64), 0.99))
            w = -(-int(need * 1.5) // 8) * 8
            self.aps_plan_width = int(min(max(w, 8), pids.shape[1]))
        self._calibrate_radius_predictor(q, pids, self_ids, gt, float(target), k, goal)

    def _calibrate_radius_predictor(self, q, pids, self_ids, gt, target: float, k: int,
                                    goal: float, kmax: int = 100, nq_fit: int = 256):
        """Fit and validate the oneshot radius model, then the candidate-width
        cap, the dense-prefix width and (v10/v11 scans only) the pair budget
        (quake_tpu/index.py::_calibrate_radius_predictor). q, pids: the
        calibration queries and their candidates; self_ids, gt: their source
        ids and ground truth (_recall_without_self)."""
        state = self.store.state
        dev = self.device
        kmax = int(min(kmax, max(self.ntotal() - 2, 1)))
        fit_ids = self.store.get_ids()[:nq_fit]
        qf_np, found = self.store.get_vectors(fit_ids)
        qf_np = np.ascontiguousarray(qf_np[found], dtype=np.float32)
        if qf_np.shape[0] < 16:
            return
        fit_self = np.asarray(fit_ids)[found].astype(np.int64)
        qf = torch.from_numpy(qf_np).to(dev)

        # Exact (kmax+1)-th distances, the self match dropped per row (the
        # last column where the self id is absent).
        s_all, i_all = coordinator.flat_search(state.codes, state.ids, qf, kmax + 1, self.metric)
        s_np = s_all.cpu().numpy().astype(np.float32)
        i_np = i_all.cpu().numpy().astype(np.int64)
        S = s_np.shape[0]
        keep = np.ones_like(s_np, bool)
        for r in range(S):
            hits = np.nonzero(i_np[r] == fit_self[r])[0]
            keep[r, hits[0] if len(hits) else kmax] = False
        s_kept = s_np[keep].reshape(S, kmax)
        if self.metric == "l2":
            radii = np.sqrt(np.maximum(-s_kept, 0.0))
        else:
            q_sq = np.sum(qf_np ** 2, axis=1)[:, None]
            radii = np.sqrt(np.maximum(q_sq + 1.0 - 2.0 * s_kept, 0.0))

        # d1: the distance to the nearest centroid, as oneshot serving takes it.
        _, p_ids32, _ = self.parent._search_device(qf, SearchParams(k=1, batched_scan=True),
                                                   approx_flat=True)
        pid0 = p_ids32.cpu().numpy().astype(np.int64)[:, 0]
        cents = state.centroids.cpu().numpy().astype(np.float32)[np.maximum(pid0, 0)]
        d1 = np.linalg.norm(qf_np - cents, axis=1)

        X = np.stack([np.ones_like(d1), d1], axis=1)
        coef, *_ = np.linalg.lstsq(X, radii, rcond=None)  # [2, kmax]
        resid = radii - X @ coef
        shift = np.quantile(resid, 0.9, axis=0)

        # Validate end to end; scale the shift until the goal holds.
        table = beta_table(self.aps_dimension or self.d(), "l2", dev)
        kc = min(k, kmax)
        oneshot = dict(k=k + 1, metric=self.metric, dimension=self.aps_dimension or self.d(),
                       use_precomputed=True, table=table, qt=32, kernel=self._grouped_kernel(),
                       sizes=state.sizes, norms=state.norms,
                       gamma=self.aps_gamma if self.aps_gamma != 1.0 else None)

        def trial(cand, ra, rb, **budget):
            return coordinator.aps_search_oneshot(state.codes, state.ids, state.centroids, q,
                                                  cand, target, radius_a=ra, radius_b=rb,
                                                  **oneshot, **budget)

        ok_scale = None
        for scale in (1.0, 1.25, 1.6, 2.0, 3.0):
            _, ids32, sc = trial(pids, float(coef[0, kc - 1] + scale * shift[kc - 1]),
                                 float(coef[1, kc - 1]))
            if _recall_without_self(ids32, self_ids, gt, k) >= goal:
                ok_scale = scale
                break
        if ok_scale is None:
            return  # the predictor cannot meet the target: oneshot stays off
        ab = np.stack([coef[0] + ok_scale * shift, coef[1]], axis=1)
        self.aps_radius_ab = ab.astype(np.float32)  # [kmax, 2]
        ra = float(self.aps_radius_ab[kc - 1, 0])
        rb = float(self.aps_radius_ab[kc - 1, 1])

        # Candidate-width cap: multiples of 8 at 1.25, 2 and 4 times the mean
        # plan, tightest first, each validated with the cap applied.
        mean_plan = max(float(sc.cpu().numpy().mean()), 1.0)
        cands_m = []
        for f in (1.25, 2.0, 4.0):
            m = int(max(16, -(-int(f * mean_plan) // 8) * 8))
            if m < pids.shape[1] and m not in cands_m:
                cands_m.append(m)
        sc_at_width = sc
        for mcap in cands_m:
            _, ids32, sc_m = trial(pids[:, :mcap], ra, rb)
            if _recall_without_self(ids32, self_ids, gt, k) >= goal:
                self.aps_oneshot_mcap = mcap
                sc_at_width = sc_m
                break

        # Dense-prefix width: the smallest ranked prefix whose membership
        # recall meets the goal, and whose one-sided 95% lower confidence
        # bound on the per-query mean meets the target.
        # A ground-truth id is found through either copy on a spilled store.
        gt64 = np.asarray(gt, np.int64)
        nq_v, kk = gt64.shape
        pids_np = pids.cpu().numpy().astype(np.int64)
        Wc = pids_np.shape[1]
        first = np.full((nq_v, kk), Wc, np.int64)
        for id_map in (self.store.id_map, self.store.spill_map):
            if id_map is None or not len(id_map):
                continue
            owner = id_map.get_batch(gt64.ravel()).astype(np.int64).reshape(nq_v, kk)
            match = (owner[:, :, None] == pids_np[:, None, :]) & (owner[:, :, None] >= 0)
            first = np.minimum(first, np.where(match.any(-1), match.argmax(-1), Wc))
        z95 = 1.645
        for w in range(1, Wc + 1):
            per_q = (first < w).mean(axis=1)
            p_hat = float(per_q.mean())
            se = float(per_q.std(ddof=1)) / float(np.sqrt(nq_v)) if nq_v > 1 else 1.0
            if p_hat >= goal and p_hat - z95 * se >= target:
                self.aps_dense_w = w
                self.aps_calib_target = float(target)
                self.aps_calib_nq = int(nq_v)
                break

        # The pair budget, on the v10/v11 scans only (elsewhere the budget
        # would clip plans with no machinery to shrink): width_clip = p99 of
        # the plans + 4, up to a multiple of 8; budget_w from the mean plan
        # at 1.15x then 1.5x, each validated with the budget active.
        if not self._grouped_kernel().startswith(("v10", "v11")):
            return
        W = self.aps_oneshot_mcap or pids.shape[1]
        sc_np = sc_at_width.cpu().numpy().astype(np.float64)
        wclip = int(min(-(-int(np.quantile(sc_np, 0.99) + 4) // 8) * 8, W))
        mean_sc = float(sc_np.mean())
        for f in (1.15, 1.5):
            bw = int(min(-(-int(f * mean_sc + 2) // 4) * 4, wclip))
            _, ids32, _ = trial(pids[:, :W], ra, rb, width_clip=wclip, budget_w=bw)
            if _recall_without_self(ids32, self_ids, gt, k) >= goal:
                self.aps_width_clip = wclip
                self.aps_budget_w = bw
                self.aps_calib_target = float(target)
                self.aps_calib_nq = int(q.shape[0])
                break

    def _grouped_kernel(self) -> str:
        """Grouped-scan choice, read at each search. QUAKE_TPU_KERNEL names a
        scan for A/B runs, as in the JAX package ("v3p", "v3p4", "v7g4",
        "v8", "v9g2", "v10g4", "v11g4f256", "v3", "v2", "v4c128g8", "v5",
        "v6c128", "xla", ...; see coordinator.grouped_scan).
        Without it: the v11 grouped scan with the JAX package's
        groups-per-step rule. gpb only pads the group count to a multiple
        (it sets the sort-key bit budget and so the placement); kernel K1
        runs one block per group whatever it is. Where the JAX package's
        rule gives up on its Pallas kernels (a slab too large for its fast
        memory), K1 still runs, at gpb = 1: its bodies serve every D (the
        query-tile height follows D, see _k1_qt). A CPU index runs v11 on
        the plain versions where the JAX package runs "xla" off the TPU. The
        slab's bytes count 2 an element for bf16 codes, as in the JAX
        package (gpb sets the placement, so both packages place alike)."""
        override = os.environ.get("QUAKE_TPU_KERNEL")
        if override:
            return override
        slab = self.store.C * self.d() * self.store.state.codes.element_size()
        gpb = max(1, min(4, (12 << 20) // max(2 * slab, 1)))
        return f"v11g{gpb}"

    def _k1_qt(self, qt: int) -> int:
        """The largest query-tile height of 64, 32, 16 and 8, at most qt, at
        which kernel K1 runs its tensor-core body for this index's D and
        codes dtype, asked of the built library
        (ops/grouped_scan.grouped_scan_uses_mma); qt itself where there is
        none (a row not 16-byte aligned, or a D too wide for any tile: the
        CUDA-core body serves every D at every height). A kernel row's
        selection reads only its own query and its partition, so qt changes
        no result."""
        dtype = self.store.state.codes.dtype
        return next((t for t in QTS if t <= qt and grouped_scan_uses_mma(t, self.d(), dtype)),
                    qt)

    def _parent_kernel(self) -> str:
        """Parent ranking of the fused fixed-nprobe path, read at each search:
        QUAKE_TPU_PARENT_KERNEL for A/B runs ("pallas" = kernel K3, "approx"
        = the flat scan; see coordinator.rank_parents), else "pallas" on a
        CUDA index and "approx" on a CPU one (the JAX package: "pallas" on a
        TPU backend, else "approx")."""
        override = os.environ.get("QUAKE_TPU_PARENT_KERNEL")
        if override:
            return override
        return "pallas" if self.device.type == "cuda" else "approx"

    def _grouped_params(self, B: int, parent_k: int):
        """(qt, group_chunk), by the JAX package's rules. The query-tile
        height qt tracks the expected queries per partition, a power of two
        in [8, 64]; on a CUDA index it then drops to the largest height at
        which kernel K1's tensor-core body serves D (_k1_qt; D = 768 runs at
        qt = 32), where one does. group_chunk, the groups the "xla" scan gathers at a time,
        keeps a chunk's slabs near 128 MB, within [8, 128], counting 4 bytes
        an element whatever the codes' dtype, as the JAX package does."""
        qt = min(64, max(8, next_pow2(B * parent_k // max(self.nlist(), 1) or 1)))
        if self.device.type == "cuda":
            qt = self._k1_qt(qt)
        slab_bytes = max(self.store.C * self.d() * 4, 1)
        return qt, max(8, min(128, (1 << 27) // slab_bytes))

    # ----------------------------------------------------------------- modify

    def _validate_new_ids(self, ids: np.ndarray, check_resident: bool = True) -> None:
        """partition_manager.cpp:163-184: unique, in range, not resident (in
        the id map or among the pending adds)."""
        if ids.size == 0:
            return
        if ids.min() < 0:
            raise ValueError("vector ids must be non-negative")
        if ids.max() >= INT32_MAX:
            raise ValueError("vector ids must be < INT32_MAX")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids in input")
        if check_resident and self.store is not None:
            resident = self.store.id_map.contains_batch(ids)
            if resident.any():
                raise ValueError(f"ids already in index (e.g. {ids[resident][:5].tolist()})")
            if self._pending_idset:
                dup = [i for i in ids.tolist() if i in self._pending_idset]
                if dup:
                    raise ValueError(f"ids already in index (pending, e.g. {dup[:5]})")

    def add(self, x, ids) -> ModifyTimingInfo:
        """Insert vectors (quake_index.cpp:122-130, partition_manager.cpp:123-262).

        With IndexBuildParams.mutation_buffer_size > 0, the adds to an IVF
        index collect in a buffer until it holds that many vectors, then go
        in with one assignment and one append; every read and every other
        mutation flushes the buffer first, so what a caller observes is
        unchanged."""
        with annotate("quake.add"):
            timing = ModifyTimingInfo()
            t0 = _now_us()
            x = to_f32(x)
            if x.ndim == 1:
                x = x[None, :]
            ids = to_i64(ids)
            timing.n_vectors = x.shape[0]
            with annotate("quake.add.validate"):
                self._validate_new_ids(ids)
            timing.input_validation_time_us = _now_us() - t0

            buf = self.build_params.mutation_buffer_size if self.build_params else 0
            if buf > 0 and self.parent is not None:
                self._pending_x.append(x)
                self._pending_vids.append(ids)
                self._pending_idset.update(ids.tolist())
                if sum(len(v) for v in self._pending_vids) >= buf:
                    t2 = _now_us()
                    self._flush_mutations()
                    timing.modify_time_us = _now_us() - t2
                return timing

            t1 = _now_us()
            if self.parent is not None and self.spill:
                with annotate("quake.add.assign"):
                    rows, srows = self._assign_rows_spill(x)
                timing.find_partition_time_us = _now_us() - t1
                t2 = _now_us()
                self._append_spilled(rows, srows, x, ids)
                timing.modify_time_us = _now_us() - t2
                return timing
            if self.parent is not None:
                with annotate("quake.add.assign"):
                    rows = self._ensure_room_by_splitting(self._assign_rows(x), x, ids)
            else:
                rows = np.zeros(x.shape[0], dtype=np.int32)
            timing.find_partition_time_us = _now_us() - t1
            t2 = _now_us()
            self.store.append(rows, x, ids)
            timing.modify_time_us = _now_us() - t2
            return timing

    def _flush_mutations(self) -> None:
        """Insert all buffered vectors with one assignment and one append
        (in the spans of an add)."""
        if not self._pending_vids:
            return
        with annotate("quake.add"):
            x = np.concatenate(self._pending_x)
            ids = np.concatenate(self._pending_vids)
            self._pending_x.clear()
            self._pending_vids.clear()
            self._pending_idset.clear()
            if self.spill:
                with annotate("quake.add.assign"):
                    rows, srows = self._assign_rows_spill(x)
                self._append_spilled(rows, srows, x, ids)
                return
            with annotate("quake.add.assign"):
                rows = self._ensure_room_by_splitting(self._assign_rows(x), x, ids)
            self.store.append(rows, x, ids)

    def remove(self, ids) -> ModifyTimingInfo:
        """Remove by id (quake_index.cpp:132-140), routed through the id map
        to the partitions that hold them; ids not in the index are ignored."""
        with annotate("quake.remove"):
            timing = ModifyTimingInfo()
            t0 = _now_us()
            self._flush_mutations()
            ids = to_i64(ids)
            timing.n_vectors = ids.shape[0]
            t1 = _now_us()
            self.store.remove(ids)
            timing.modify_time_us = _now_us() - t1
            timing.input_validation_time_us = t1 - t0
            return timing

    def modify(self, ids, x) -> ModifyTimingInfo:
        """Overwrite resident vectors in place (quake_index.h modify); both
        copies on a spilled index."""
        timing = ModifyTimingInfo()
        t0 = _now_us()
        self._flush_mutations()
        ids = to_i64(ids)
        timing.n_vectors = ids.shape[0]
        self.store.update_vectors(ids, to_f32(x))
        timing.modify_time_us = _now_us() - t0
        return timing

    def get(self, ids) -> np.ndarray:
        """Vectors by id (quake_index.h get); KeyError names missing ids."""
        self._flush_mutations()
        ids = to_i64(ids)
        vecs, found = self.store.get_vectors(ids)
        if not found.all():
            raise KeyError(f"ids not in index (e.g. {ids[~found][:5].tolist()})")
        return vecs

    def get_ids(self) -> np.ndarray:
        """The resident ids, in the id map's order (sort to compare)."""
        self._flush_mutations()
        return self.store.get_ids()

    def _assign_rows(self, x: np.ndarray) -> np.ndarray:
        """Exact 1-NN partition of each vector through the flat parent
        (partition_manager.cpp:219-231), on the index's device. The parent's
        exact flat scan, never its approximate ranking (approx_flat)."""
        sp = SearchParams(k=1, nprobe=self.parent.nlist(), batched_scan=True)
        q = torch.from_numpy(x).to(self.device)
        _, rows32, _ = self.parent._search_device(q, sp)
        return rows32[:, 0].cpu().numpy().astype(np.int32)

    def _assign_rows_spill(self, x: np.ndarray):
        """(primary, spill) rows of each vector by the build's SOAR
        objective (kmeans.soar_assign) against the active centroids, on the
        index's device (quake_tpu/index.py::_assign_rows_spill)."""
        rows_act = self.store.active_rows()
        cents = self.store.state.centroids[torch.from_numpy(rows_act).to(self.device)]
        a1, a2 = soar_assign(x, cents.cpu().numpy(), self.soar_lambda, device=self.device)
        return rows_act[a1].astype(np.int32), rows_act[a2].astype(np.int32)

    def _append_spilled(self, rows, srows, x, ids):
        """Insert both copies of each vector through ONE overflow-splitting
        pass over the combined set (a flood's primary and spill targets are
        both split rather than growing C), then the primaries and the spill
        copies that pass left (quake_tpu/index.py::_append_spilled)."""
        n = len(rows)
        ids = to_i64(ids)
        with annotate("quake.add.assign"):
            rows_comb = self._ensure_room_by_splitting(
                np.concatenate([rows, srows]), np.concatenate([x, x]), np.concatenate([ids, ids]),
                incoming_spill=np.concatenate([np.zeros(n, bool), np.ones(n, bool)]))
        self.store.append_primaries(rows_comb[:n], x, ids)
        self.store.append_spill_copies(rows_comb[n:], x, ids)

    def _replace_partitions(self, old_rows, cents, vecs, ids, spill_flags=None) -> list:
        """Swap partitions old_rows for new ones (centroid, vectors and ids
        each, and on a spilled index whether each copy is a spill copy):
        the parent forgets the old centroids before it learns the new
        ones, because a freed row is reused at once, with its generation
        moved on. Returns the new rows."""
        store = self.store
        self.parent.remove(np.asarray(old_rows, dtype=np.int64))
        store.delete_partitions(old_rows)
        new_rows = store.allocate_rows(len(cents))
        store.write_partitions(new_rows, vecs, ids, cents, spill_flags_list=spill_flags)
        self.parent.add(np.asarray(cents, dtype=np.float32), np.asarray(new_rows, dtype=np.int64))
        return new_rows

    def split_partitions(self, rows) -> list:
        """2-way k-means of each partition; the originals are deleted and the
        halves added (partition_manager.cpp:393-445, quake_tpu/index.py:
        1588-1658). Used by maintenance splits. Returns the new rows. By
        default one batched 2-means over all the rows' slabs on the index's
        device (kmeans.batched_two_means) and one copy of the result to the
        host; with QUAKE_TPU_MAINT_HOST=1, and always on a spilled index (as
        in the JAX package), the host path: kmeans_np of each partition read
        one by one, each moved copy keeping its map."""
        rows = [int(r) for r in rows]
        if not rows:
            return []
        cents, vecs, ids, flags = [], [], [], []
        if not maint_on_host() and not self.spill:
            state = self.store.state
            rows_p = np.full(_bucket(len(rows), 1), -1, np.int32)
            rows_p[:len(rows)] = rows
            slabs, slab_ids, sizes, cents_d, assign = batched_two_means(
                state.codes, state.ids, state.sizes, torch.from_numpy(rows_p).to(self.device),
                niter=5, metric=self.metric)
            n = len(rows)
            slabs, sizes = slabs[:n].cpu().numpy(), sizes[:n].cpu().numpy()
            slab_ids = slab_ids[:n].cpu().numpy().astype(np.int64)
            cents_np, assign = cents_d[:n].cpu().numpy(), assign[:n].cpu().numpy()
            for i in range(n):
                sz = int(sizes[i])
                for j in range(2):
                    m = assign[i, :sz] == j
                    cents.append(cents_np[i, j])
                    vecs.append(slabs[i, :sz][m])
                    ids.append(slab_ids[i, :sz][m])
        else:
            for r in rows:
                cents_r, clusters = kmeans_np(*self.store.get_partition(r), 2, self.metric)
                for c, (cvecs, cids) in zip(cents_r, clusters):
                    cents.append(c)
                    vecs.append(cvecs)
                    ids.append(cids)
                    if self.spill:  # the copy here is the spill one iff spill_map says r
                        flags.append(self.store.spill_map.get_batch(cids) == r)
        return self._replace_partitions(rows, cents, vecs, ids, flags if self.spill else None)

    def _ensure_room_by_splitting(self, rows: np.ndarray, x: np.ndarray, ids: np.ndarray,
                                  incoming_spill=None) -> np.ndarray:
        """Capacity isolation (quake_tpu/index.py:1694-1797): where an insert
        batch would overflow a partition's slab AND that partition is an
        outlier (its need above 1.5 x the mean after the insert, rounded up
        to 256: the build-time balancer's cap), split it k ways over the union
        of its residents and the incoming vectors, inserting them on the way.
        Uniform growth still grows C (append's ensure_capacity); one hot
        partition no longer doubles every slab. k-means cannot separate a
        flood of near-duplicates, so a cell above the target fill is chopped
        by order into pieces. Returns rows with the vectors inserted here set
        to -1.

        A spilled index calls this once over the combined primary and spill
        insertions (incoming_spill marks the spill copies; the mean counts
        both copies of every vector); within a split group an id appears at
        most once, so each written copy keeps its map through (row, id)."""
        store = self.store
        need = store.partition_sizes() + np.bincount(rows[rows >= 0], minlength=store.P)
        over = np.nonzero(need > store.C)[0]
        if over.size == 0:
            return rows
        phys = 2 if self.spill else 1
        mean_after = (self.ntotal() * phys + int((rows >= 0).sum())) / max(self.nlist(), 1)
        cap = max(256, -(-int(1.5 * mean_after) // 256) * 256)
        split_rows = [int(r) for r in over if need[r] > cap]
        if not split_rows:
            return rows

        rows = rows.copy()
        ids = to_i64(ids)
        target_fill = max(int(0.75 * store.C), 1)
        cents, vecs, vids, flags = [], [], [], []
        for r in split_rows:
            res_vecs, res_ids = store.get_partition(r)
            m = rows == r
            uv = np.concatenate([res_vecs, x[m]])
            uids = np.concatenate([res_ids, ids[m]])
            if self.spill:  # ids whose copy in this group is the spill copy
                spilled = res_ids[store.spill_map.get_batch(res_ids) == r]
                if incoming_spill is not None:
                    spilled = np.concatenate([spilled, ids[m & incoming_spill]])
            cents_r, clusters = kmeans_np(uv, uids, max(2, -(-len(uids) // target_fill)),
                                          self.metric)
            pieces = []
            for c, (cvecs, cids) in zip(cents_r, clusters):
                if len(cids) <= target_fill:
                    pieces.append((c, cvecs, cids))
                    continue
                n_chunks = -(-len(cids) // target_fill)
                for piece_v, piece_i in zip(np.array_split(cvecs, n_chunks),
                                            np.array_split(cids, n_chunks)):
                    pieces.append((piece_v.mean(axis=0, dtype=np.float64).astype(np.float32),
                                   piece_v, piece_i))
            for c, pv, pi in pieces:
                cents.append(c)
                vecs.append(pv)
                vids.append(pi)
                if self.spill:
                    flags.append(np.isin(pi, spilled))
            rows[m] = -1
        self._replace_partitions(split_rows, cents, vecs, vids, flags if self.spill else None)
        return rows

    # ------------------------------------------------------------ maintenance

    def maintenance(self) -> MaintenanceTimingInfo:
        """Cost-based split and delete, then local refinement
        (quake_index.cpp:157-163), after the pending adds are flushed. A
        flat index has no policy and does nothing."""
        with annotate("quake.maintenance"):
            if self.maintenance_policy is None:
                return MaintenanceTimingInfo()
            self._flush_mutations()
            return self.maintenance_policy.perform_maintenance()

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        """Directory save in the JAX package's format (quake_index.cpp:
        170-206, quake_tpu/index.py:1815-1870): metadata.json, the store's
        arrays as .npy (bf16 codes as their uint16 bit view, np.save has no
        bf16; norms are derived, and recomputed on load), the latency grid
        as latency_profile.csv where there is one, and a recursive parent/.
        Either package loads what the other saved."""
        self._flush_mutations()
        os.makedirs(path, exist_ok=True)
        state = self.store.state
        meta = {
            "version": SERIALIZATION_VERSION,
            "metric": self.metric,
            "level": self.level,
            "dimension": self.d(),
            "ntotal": self.ntotal(),
            "nlist": self.nlist(),
            "precision": "bf16" if state.codes.dtype == torch.bfloat16 else "f32",
            "has_parent": self.parent is not None,
            "aps_dimension": self.aps_dimension,
            **{name: getattr(self, name) for name in APS_FIELDS},
            "spill": self.spill,
            "soar_lambda": self.soar_lambda,
            "free_rows": [int(r) for r in self.store.free_rows],
        }
        if self.aps_radius_ab is not None:
            meta["aps_radius_ab"] = np.asarray(self.aps_radius_ab).tolist()
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)
        codes = state.codes
        if codes.dtype == torch.bfloat16:  # saved as the uint16 view of its bits
            codes = codes.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            codes = codes.cpu().numpy()
        np.save(os.path.join(path, "codes.npy"), codes)
        for name in ("ids", "sizes", "centroids", "active"):
            np.save(os.path.join(path, f"{name}.npy"), getattr(state, name).cpu().numpy())
        np.save(os.path.join(path, "generation.npy"), self.store.generation)
        if self.latency_profile is not None:
            self.latency_profile.save(os.path.join(path, "latency_profile.csv"))
        if self.parent is not None:
            self.parent.save(os.path.join(path, "parent"))

    def load(self, path: str, n_workers: int = 0) -> "QuakeIndex":
        """Load a saved index onto this index's device (quake_index.cpp:
        208-267, quake_tpu/index.py:1872-1964): the arrays, the free rows and
        the generation counters as saved, the codes in the precision the
        metadata names (bf16 from the uint16 bit view), the norms recomputed
        from the codes, the id map rebuilt from the slots, the latency grid
        from latency_profile.csv, and a fresh maintenance policy. A spilled
        index's slots are split between its maps as the JAX package splits
        them (each id's first occurrence in row-major order primary, the
        second spill). A bf16 parent loads as bf16, as any level. n_workers >
        1 shards the loaded index over that many CUDA devices where there
        are as many (_would_shard; a CPU index counts as one device), as
        the reference re-creates its workers at load."""
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta["version"] != SERIALIZATION_VERSION:
            raise ValueError(f"unsupported serialization version {meta['version']}")
        bf16 = meta.get("precision") == "bf16"
        self.mesh, self._sharded = None, None
        self.metric = check_metric(meta["metric"])
        self.level = meta["level"]
        self.aps_dimension = meta.get("aps_dimension", 0)
        for name, default in APS_FIELDS.items():
            setattr(self, name, meta.get(name, default))
        if self.aps_radius_ab is not None:
            self.aps_radius_ab = np.asarray(self.aps_radius_ab, np.float32)
        self.spill = bool(meta.get("spill", False))
        self.soar_lambda = float(meta.get("soar_lambda", 1.0))

        arrays = {name: torch.from_numpy(np.load(os.path.join(path, f"{name}.npy")))
                  .to(self.device) for name in ("ids", "sizes", "centroids", "active")}
        codes = np.load(os.path.join(path, "codes.npy"))
        codes = (torch.from_numpy(codes.view(np.int16)).view(torch.bfloat16)
                 if codes.dtype == np.uint16 else torch.from_numpy(codes))
        # In the precision the metadata names, as the JAX package's
        # jnp.asarray(codes, dtype) gives it.
        arrays["codes"] = codes.to(self.device).to(torch.bfloat16 if bf16 else torch.float32)
        # Norms are derived data: recomputed, as the JAX package does.
        arrays["norms"] = _sumsq(arrays["codes"])
        self.store = PartitionStore(meta["dimension"], self.device,
                                    dtype=arrays["codes"].dtype)
        self.store.init_from_state(StoreState(**arrays), free_rows=meta["free_rows"],
                                   generation=np.load(os.path.join(path, "generation.npy")),
                                   spill=self.spill)
        self.parent = None
        if meta["has_parent"]:
            self.parent = QuakeIndex(level=self.level + 1, device=self.device)
            self.parent.load(os.path.join(path, "parent"))
        self.build_params = IndexBuildParams(dimension=meta["dimension"], nlist=meta["nlist"],
                                             metric=self.metric,
                                             precision="bf16" if bf16 else "f32")
        # A fresh policy on the saved latency grid; the hit window is not
        # saved (quake_index.cpp:208-267).
        self.latency_profile = ListScanLatencyEstimator.from_csv(
            os.path.join(path, "latency_profile.csv"))
        self.maintenance_policy = None
        self.initialize_maintenance_policy(MaintenancePolicyParams())
        if self._would_shard(n_workers):
            self.shard(n_workers)
        return self

    # ------------------------------------------------------------- accessors

    def ntotal(self) -> int:
        """Resident vectors, the pending adds included."""
        n = self.store.ntotal() if self.store else 0
        return n + sum(len(v) for v in self._pending_vids)

    def parent_ntotal(self) -> int:
        return self.parent.ntotal() if self.parent else 0

    def nlist(self) -> int:
        return self.store.nlist() if self.store else 0

    def d(self) -> int:
        return self.store.d if self.store else 0

    def centroids(self) -> np.ndarray:
        """The active partitions' centroids, as numpy: the first nlist rows
        of a flat index, else the store's active rows in ascending order."""
        cents = self.store.state.centroids.cpu().numpy()
        if self.parent is None:
            return cents[:self.nlist()]
        return cents[self.store.active_rows()]

    def validate(self) -> bool:
        """Consistency check (quake_index.h validate): every row a compact
        prefix of ids, the sizes summing to ntotal (twice ntotal on a
        spilled index, whose ntotal stays logical), and the parent holding
        one centroid per partition."""
        self._flush_mutations()
        st = self.store.state
        below = torch.arange(self.store.C, device=st.ids.device)[None, :] < st.sizes[:, None]
        if not torch.equal(st.ids >= 0, below):
            return False
        if int(st.sizes.sum()) != self.ntotal() * (2 if self.spill else 1):
            return False
        return self.parent is None or self.parent.ntotal() == self.nlist()
