"""QuakeIndex: build, and the flat, the query-major and the batched
fixed-nprobe searches (that part of quake_tpu/index.py).

A recursive two-level IVF structure, as in the reference orchestrator
(src/cpp/include/quake_index.h:18-142, src/cpp/src/quake_index.cpp:29-288):
`parent` is a flat QuakeIndex over the partition centroids. The compute runs
as PyTorch and CUDA launches over the padded partition store on `device`;
this class is the host-side control plane (validation, id bookkeeping,
recursion, timing).

What this package does not implement yet raises NotImplementedError naming
the ROADMAP item that will lift it; nothing is silently skipped.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from quake_tpu_torch import coordinator
from quake_tpu_torch.geometry import effective_dimension
from quake_tpu_torch.kmeans import balance_clusters, kmeans_fit_assign
from quake_tpu_torch.ops.grouped import grouped_scan_xla
from quake_tpu_torch.ops.grouped_scan import QTS, grouped_scan_uses_mma
from quake_tpu_torch.ops.scan import scores_to_distances
from quake_tpu_torch.params import IndexBuildParams, SearchParams, check_metric
from quake_tpu_torch.storage.store import PartitionStore
from quake_tpu_torch.timing import BuildTimingInfo, SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import next_pow2, to_f32, to_i64

INT32_MAX = np.iinfo(np.int32).max
MIN_BATCH = 16  # smaller batches take the query-major path


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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


class QuakeIndex:
    """Dynamic IVF index: build plus flat and fixed-nprobe search."""

    def __init__(self, level: int = 0, device=None):
        self.level = level
        self.device = resolve_device(device)
        self.metric: str = "l2"
        self.store: Optional[PartitionStore] = None
        self.parent: Optional["QuakeIndex"] = None
        self.build_params: Optional[IndexBuildParams] = None
        self.aps_dimension = 0  # effective dimension for the APS recall model
        self._nprobe_bucket = 8  # pow2 padding for probe lists

    # ------------------------------------------------------------------ build

    @staticmethod
    def _check_build_params(bp: IndexBuildParams, n: int) -> None:
        if bp.precision != "f32":
            raise _not_ported(f"precision={bp.precision!r}",
                              "ROADMAP Queue 1 item 8: bf16 and exact=False")
        if bp.spill:
            raise _not_ported("spill=True", "ROADMAP Queue 1 item 8: spill/dedup")
        if bp.num_shards > 1 or bp.num_workers > 1:
            raise _not_ported("num_shards/num_workers > 1",
                              "ROADMAP Queue 1 item 11: parallel")
        if bp.nlist > 1 and bp.calibrate_aps and n >= 10_000:
            raise _not_ported("calibrate_aps=True (pass calibrate_aps=False)",
                              "ROADMAP Queue 1 item 9: APS")
        if bp.profile_maintenance_latency:
            raise _not_ported("profile_maintenance_latency=True",
                              "ROADMAP Queue 1 item 10: maintenance")
        if bp.nlist > 1 and bp.parent_params is not None and bp.parent_params.nlist > 1:
            raise _not_ported("a parent index that is itself an IVF",
                              "ROADMAP Queue 1: multi-level parents")

    def build(self, x, ids=None, build_params: Optional[IndexBuildParams] = None) -> BuildTimingInfo:
        """Build the index (quake_index.cpp:29-90)."""
        t0 = _now_us()
        bp = build_params or IndexBuildParams()
        self.metric = check_metric(bp.metric)
        x = to_f32(x)
        n, d = x.shape
        self._check_build_params(bp, n)
        self.build_params = bp
        if bp.dimension and bp.dimension != d:
            raise ValueError(f"dimension mismatch: params say {bp.dimension}, data is {d}")
        bp.dimension = d
        ids = np.arange(n, dtype=np.int64) if ids is None else to_i64(ids)
        if ids.shape[0] != n:
            raise ValueError("ids length must match number of vectors")
        self._validate_new_ids(ids)

        self.store = PartitionStore(d, self.device)
        timing = BuildTimingInfo(n_vectors=n, n_clusters=max(bp.nlist, 1), d=d)
        if bp.nlist > 1:
            self.aps_dimension = effective_dimension(x)
            t_train = _now_us()
            centroids, assignments = kmeans_fit_assign(
                torch.from_numpy(x).to(self.device), bp.nlist, metric=self.metric,
                niter=bp.niter)
            centroids_np = centroids.cpu().numpy()
            assigns_np = assignments.cpu().numpy()
            if bp.balance_partitions:
                # Bound slab padding: split clusters above balance_factor x
                # the mean (see kmeans.balance_clusters).
                mean = max(n // max(bp.nlist, 1), 1)
                cap = max(256, -(-int(bp.balance_factor * mean) // 128) * 128)
                centroids_np, assigns_np = balance_clusters(x, centroids_np, assigns_np, cap)
            nlist_final = centroids_np.shape[0]
            timing.train_time_us = _now_us() - t_train
            timing.n_clusters = nlist_final

            t_assign = _now_us()
            self.store.init_from_assignments(x, ids, centroids_np, assigns_np)
            timing.assign_time_us = _now_us() - t_assign

            # Recursive flat parent over the centroids (quake_index.cpp:57-61).
            parent_bp = bp.parent_params or IndexBuildParams(metric=bp.metric, nlist=0)
            parent_bp.metric = bp.metric
            self.parent = QuakeIndex(level=self.level + 1, device=self.device)
            self.parent.build(centroids_np, np.arange(nlist_final, dtype=np.int64), parent_bp)
        else:
            # Flat: one partition holding everything (quake_index.cpp:68-79).
            if bp.spill:
                raise ValueError("spill requires an IVF index (nlist > 1)")
            self.store.init_single_partition(x, ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing.total_time_us = _now_us() - t0
        return timing

    def _validate_new_ids(self, ids: np.ndarray) -> None:
        """partition_manager.cpp:163-184: unique, in range."""
        if ids.size == 0:
            return
        if ids.min() < 0:
            raise ValueError("vector ids must be non-negative")
        if ids.max() >= INT32_MAX:
            raise ValueError("vector ids must be < INT32_MAX")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids in input")

    # ----------------------------------------------------------------- search

    def search(self, x, search_params: Optional[SearchParams] = None) -> SearchResult:
        """Top-k search (quake_index.cpp:93-99, query_coordinator.cpp:612-657).

        Timing phases:
          buffer_init      = query validation + host->device copy
          job_enqueue      = enqueueing the search's launches
          job_wait         = device execution + the id copy back to the host
          result_aggregate = the distance copy and conversion
        """
        t0 = _now_ns()
        sp = search_params or SearchParams()
        x = to_f32(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.d():
            raise ValueError(f"query dimension {x.shape[1]} != index dimension {self.d()}")
        q = torch.from_numpy(x).to(self.device)
        t1 = _now_ns()
        _, ids32, timing, dists = self._search_device_full(q, sp)
        t2 = _now_ns()
        ids_np = ids32.cpu().numpy().astype(np.int64)  # waits for the device
        t3 = _now_ns()
        dists_np = dists.cpu().numpy()
        t4 = _now_ns()
        timing.buffer_init_time_ns = t1 - t0
        timing.job_enqueue_time_ns = t2 - t1
        timing.job_wait_time_ns = t3 - t2
        timing.result_aggregate_time_ns = t4 - t3
        timing.total_time_ns = t4 - t0
        return SearchResult(ids=ids_np, distances=dists_np, timing_info=timing)

    def _check_search(self, sp: SearchParams) -> None:
        if not sp.exact_distances:
            raise _not_ported("exact_distances=False",
                              "ROADMAP Queue 1 item 8: bf16 and exact=False")
        if self.parent is None:
            return  # a flat index scans everything, whatever the recall target
        if sp.recall_target > 0:
            raise _not_ported("recall_target > 0 (APS)", "ROADMAP Queue 1 item 9: APS")
        if self.parent.parent is not None:
            raise _not_ported("a parent index that is itself an IVF",
                              "ROADMAP Queue 1: multi-level parents")

    def _search_device_full(self, q: torch.Tensor, sp: SearchParams, stages=None):
        """Search of a [B, D] f32 tensor on the index's device; returns
        (scores, ids32, timing, distances) as device tensors, with the
        launches enqueued and not waited for. Batches of at least 16 queries
        take the fused partition-major path unless batched_scan is False; a
        flat index scans every slot; the rest goes query by query through
        _search_device."""
        B = int(q.shape[0])
        self._check_search(sp)
        k = max(int(sp.k), 1)
        if self.parent is None:
            # Flat exact mode (quake_index.cpp:68-79).
            timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
            state = self.store.state
            scores, ids32, dists = coordinator.fused_flat_search(state.codes, state.ids, q, k,
                                                                 self.metric)
            timing.partitions_scanned = self.nlist()
            return scores, ids32, timing, dists
        if B < MIN_BATCH or sp.batched_scan is False:
            scores, ids32, timing = self._search_device(q, sp)
            return scores, ids32, timing, scores_to_distances(scores, ids32, self.metric)
        timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
        parent_k = min(int(sp.nprobe), self.nlist())
        qt, group_chunk = self._grouped_params(B, parent_k)
        state = self.store.state
        pstate = self.parent.store.state
        scores, ids32, dists, _, _ = coordinator.fused_ivf_search(
            state.codes, state.ids, state.sizes, state.norms,
            pstate.codes, pstate.ids, q, k=k, nprobe=parent_k, metric=self.metric,
            qt=qt, kernel=self._grouped_kernel(), parent_norms=pstate.norms,
            group_chunk=group_chunk, parent_kernel=self._parent_kernel(), stages=stages)
        timing.partitions_scanned = parent_k
        timing.parent_info = SearchTimingInfo(
            n_queries=B, n_clusters=self.parent.nlist(),
            partitions_scanned=self.parent.nlist())
        return scores, ids32, timing, dists

    def _search_device(self, q: torch.Tensor, sp: SearchParams, approx_flat: bool = False):
        """The unfused search (quake_tpu/index.py::_search_device without APS
        and sharding); returns (scores, int32 ids, timing). A flat index
        scans every slot; approx_flat marks a parent centroid ranking (see
        ops/scan.py::topk_from_scores), user-facing flat searches stay
        exact. An IVF index ranks candidates through its parent, padded to a
        power of two of at least the nprobe bucket and trimmed back, then
        scans partition-major in tensor operations (batched_scan true, or
        unset with at least 16 queries) or query-major."""
        B = int(q.shape[0])
        timing = SearchTimingInfo(n_queries=B, n_clusters=self.nlist(), search_params=sp)
        k = max(int(sp.k), 1)
        state = self.store.state
        if self.parent is None:
            scores, ids32 = coordinator.flat_search(state.codes, state.ids, q, k, self.metric,
                                                    approx=approx_flat)
            timing.partitions_scanned = self.nlist()
            return scores, ids32, timing
        # Parent search for candidate partitions (query_coordinator.cpp:628-646).
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
        t1 = _now_ns()
        _, p_ids32, p_timing = self.parent._search_device(q, parent_sp, approx_flat=True)
        p_timing.total_time_ns = _now_ns() - t1  # enqueue; the device runs on
        timing.parent_info = p_timing
        pids = p_ids32[:, :parent_k]  # trim the padding back to the candidate count
        if sp.batched_scan or (sp.batched_scan is None and B >= MIN_BATCH):
            qt, group_chunk = self._grouped_params(B, parent_k)
            scores, ids32, _ = grouped_scan_xla(state.codes, state.ids, q, pids, k, self.metric,
                                                qt=qt, group_chunk=group_chunk)
        else:
            scores, ids32, _ = coordinator.ivf_search(state.codes, state.ids, q, pids, k,
                                                      self.metric)
        timing.partitions_scanned = parent_k
        return scores, ids32, timing

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
        the plain versions where the JAX package runs "xla" off the TPU."""
        override = os.environ.get("QUAKE_TPU_KERNEL")
        if override:
            return override
        slab = self.store.C * self.d() * 4
        gpb = max(1, min(4, (12 << 20) // max(2 * slab, 1)))
        return f"v11g{gpb}"

    def _k1_qt(self, qt: int) -> int:
        """The largest query-tile height of 64, 32, 16 and 8, at most qt, at
        which kernel K1 runs its tensor-core body for this index's D, asked
        of the built library (ops/grouped_scan.grouped_scan_uses_mma); qt
        itself where there is none (D % 4 != 0, or a D too wide for any
        tile: the CUDA-core body serves every D at every height). A kernel
        row's selection reads only its own query and its partition, so qt
        changes no result."""
        return next((t for t in QTS if t <= qt and grouped_scan_uses_mma(t, self.d())), qt)

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
        keeps a chunk's slabs near 128 MB, within [8, 128]."""
        qt = min(64, max(8, next_pow2(B * parent_k // max(self.nlist(), 1) or 1)))
        if self.device.type == "cuda":
            qt = self._k1_qt(qt)
        slab_bytes = max(self.store.C * self.d() * 4, 1)
        return qt, max(8, min(128, (1 << 27) // slab_bytes))

    # ------------------------------------------------------------- accessors

    def ntotal(self) -> int:
        return self.store.ntotal() if self.store else 0

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
