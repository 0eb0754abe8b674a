"""Search and k-means over a sharded store (a port of
quake_tpu/parallel/sharded.py).

A query batch goes to every shard, each shard scans its resident slice of
the probed partitions on its own device and keeps a local top-k, and the
shards' lists are gathered onto the mesh's first device and merged there
(the JAX package's all_gather + top_k over ICI; the reference's
global_topk_buffer merge, query_coordinator.cpp:172,234). The gather
concatenates the shards' lists in shard order, the order of the JAX
package's moveaxis, so ties break alike. Every result, and every piece of
state the recall-target strategies carry between scans, lives on the first
device: the APS cores (coordinator.aps_loop, aps_plan, aps_oneshot) run
unchanged over a `scan_chunk` closure that wraps the local scans and the
merge.

The shards' work is enqueued from one thread, shard after shard; a host
read inside one shard's scan waits for that shard before the next one is
enqueued.
"""

from __future__ import annotations

import torch

from quake_tpu_torch.coordinator import (aps_loop, aps_oneshot, aps_plan, aps_setup,
                                         grouped_scan)
from quake_tpu_torch.ops.scan import (dedup_topk, flat_scan, ivf_scan, scores_to_distances,
                                      topk_from_scores)
from quake_tpu_torch.profiling import annotate


def _gather(parts, first):
    """The shards' [B, kk] tensors on the first device, concatenated along
    the columns in shard order."""
    return torch.cat([p.to(first) for p in parts], dim=1)


def _merge_gathered(scores, ids32, k: int, first, dedup: bool = False):
    """Gather each shard's top-k and reduce to the global top-k
    (quake_tpu/parallel/sharded.py::_merge_gathered). dedup (a SOAR-spilled
    store, whose two copies of a vector can come from two shards): a pool
    of min(2k, ndev * kk), then each id's best entry (dedup_topk)."""
    all_s, all_i = _gather(scores, first), _gather(ids32, first)
    if dedup:
        pool = min(2 * k, all_s.shape[1])
        ps, pi = topk_from_scores(all_s, all_i, pool)
        return dedup_topk(ps, pi, k)
    return topk_from_scores(all_s, all_i, k)


def _psum(values, first):
    """The sum over the shards of a per-shard tensor, on the first device."""
    total = values[0].to(first)
    for v in values[1:]:
        total = total + v.to(first)
    return total


def _owned(pids, shard: int, p_local: int):
    """Partition strategy: the global pids shard `shard` owns, as its local
    row indices, -1 elsewhere."""
    local = pids - shard * p_local
    owned = (pids >= 0) & (local >= 0) & (local < p_local)
    return torch.where(owned, local, torch.full_like(local, -1))


def _local_pids(sharded, shard: int, pids):
    """pids on shard `shard`'s device, as that shard indexes its rows."""
    p = pids.to(sharded.mesh.devices[shard])
    if sharded.strategy == "partition":
        return _owned(p, shard, sharded.codes[shard].shape[0])
    return p


def sharded_ivf_search(sharded, q, pids, k: int, metric: str, dedup: bool = False):
    """Fixed-nprobe query-major search over a sharded store
    (quake_tpu/parallel/sharded.py::sharded_ivf_search). q [B, D] and pids
    [B, nprobe] (global partition indices, -1 pad). Under the partition
    strategy each shard scans the probed partitions it owns. Returns
    (scores [B, k], ids [B, k], scanned [B]) on the first device.

    dedup (SOAR spill): the local scan runs at 2k and both the local and the
    global merge keep distinct ids."""
    first = sharded.mesh.first
    k_loc = 2 * k if dedup else k
    out_s, out_i, scanned = [], [], []
    for s, d in enumerate(sharded.mesh.devices):
        sc, si, n = ivf_scan(q.to(d), _local_pids(sharded, s, pids), sharded.codes[s],
                             sharded.ids[s], None, k_loc, metric)
        if dedup:
            sc, si = dedup_topk(sc, si, k)
        out_s.append(sc)
        out_i.append(si)
        scanned.append(n)
    ms, mi = _merge_gathered(out_s, out_i, k, first, dedup=dedup)
    if sharded.strategy == "slot":  # every shard scanned every probe
        return ms, mi, scanned[0].to(first)
    return ms, mi, _psum(scanned, first)


def sharded_flat_search(sharded, q, k: int, metric: str, chunk_size: int = 16384):
    """Exact search of every slot of a sharded store
    (quake_tpu/parallel/sharded.py::sharded_flat_search). Returns (scores
    [B, k], ids [B, k]) on the first device."""
    out_s, out_i = [], []
    for s, d in enumerate(sharded.mesh.devices):
        Pl, Cl, D = sharded.codes[s].shape
        sc, si = flat_scan(q.to(d), sharded.codes[s].reshape(Pl * Cl, D),
                           sharded.ids[s].reshape(Pl * Cl), k, metric, chunk_size)
        out_s.append(sc)
        out_i.append(si)
    return _merge_gathered(out_s, out_i, k, sharded.mesh.first)


def _local_grouped_chunk(sharded, q, k: int, metric: str, qt: int, group_chunk: int,
                         kernel: str, exact: bool = True):
    """The scan closure of the sharded APS strategies
    (quake_tpu/parallel/sharded.py::_local_grouped_chunk):
    scan_chunk(eff, pair_budget=0) runs the masked grouped scan `kernel` (a
    coordinator.grouped_scan name, dense=False: v11 requests ride the v10
    scatter placement) on each shard's slab slice, with the shard's valid
    slot counts as sizes, and merges the shards' top-k on the first
    device."""
    first = sharded.mesh.first
    q_l = [q.to(d) for d in sharded.mesh.devices]

    def scan_chunk(eff, pair_budget=0):
        out_s, out_i = [], []
        for s in range(sharded.ndev):
            sc, si, _ = grouped_scan(sharded.codes[s], sharded.ids[s], sharded.local_sizes[s],
                                     sharded.norms[s], q_l[s], _local_pids(sharded, s, eff), k,
                                     metric, qt, group_chunk, kernel, exact=exact,
                                     pair_budget=pair_budget)
            out_s.append(sc)
            out_i.append(si)
        return _merge_gathered(out_s, out_i, k, first)

    return scan_chunk


def _aps_inputs(sharded, q, pids, dimension: int, use_precomputed: bool, table):
    """q and pids on the first device, and aps_setup's (boundary, valid,
    table) there from the replicated centroids."""
    first = sharded.mesh.first
    q, pids = q.to(first), pids.to(first)
    return (q, pids) + aps_setup(q, sharded.centroids[0], pids, dimension, use_precomputed, table)


def sharded_aps_search(sharded, q, pids, recall_target, recompute_threshold, k: int,
                       metric: str, dimension: int, chunk: int = 4,
                       use_precomputed: bool = True, table=None, qt: int = 32,
                       group_chunk: int = 64, gamma=None, kernel: str = "xla",
                       exact: bool = True, stats=None):
    """Recall-target (APS) loop over a sharded store
    (quake_tpu/parallel/sharded.py::sharded_aps_search): coordinator.
    aps_loop on the first device, each step's scan the shards' local scans
    and the merge, so the termination state is computed once from the
    merged lists (the reference worker path honouring recall_target,
    query_coordinator.cpp:243-469). `stats` as aps_loop. Returns (scores
    [B, k], ids [B, k], scanned [B]) on the first device."""
    q, pids, boundary, valid, table = _aps_inputs(sharded, q, pids, dimension,
                                                  use_precomputed, table)
    scan_chunk = _local_grouped_chunk(sharded, q, k, metric, qt, group_chunk, kernel, exact)
    return aps_loop(q, pids, boundary, valid, table, recall_target, recompute_threshold, k,
                    metric, dimension, chunk, use_precomputed, scan_chunk, gamma=gamma,
                    stats=stats)


def sharded_aps_search_planned(sharded, q, pids, recall_target, k: int, metric: str,
                               dimension: int, chunk0: int = 4, use_precomputed: bool = True,
                               table=None, qt: int = 32, group_chunk: int = 64, gamma=None,
                               plan_margin: int = 0, kernel: str = "xla", exact: bool = True,
                               width_clip: int = 0, budget_w: int = 0):
    """Planned (two-phase) APS over a sharded store
    (quake_tpu/parallel/sharded.py::sharded_aps_search_planned): the
    prologue scan, the plan from the merged prologue on the first device,
    one masked tail scan; both scans the shards' local scans and the
    merge. Returns (scores, ids, scanned) on the first device."""
    q, pids, boundary, valid, table = _aps_inputs(sharded, q, pids, dimension,
                                                  use_precomputed, table)
    scan_chunk = _local_grouped_chunk(sharded, q, k, metric, qt, group_chunk, kernel, exact)
    return aps_plan(q, pids, boundary, valid, table, recall_target, k, metric, dimension,
                    chunk0, use_precomputed, scan_chunk, gamma=gamma, plan_margin=plan_margin,
                    width_clip=width_clip, budget_w=budget_w)


def sharded_aps_search_oneshot(sharded, q, pids, recall_target, k: int, metric: str,
                               dimension: int, radius_a, radius_b, use_precomputed: bool = True,
                               table=None, qt: int = 32, group_chunk: int = 64, gamma=None,
                               plan_margin: int = 4, kernel: str = "xla", exact: bool = True,
                               width_clip: int = 0, budget_w: int = 0):
    """Oneshot APS over a sharded store
    (quake_tpu/parallel/sharded.py::sharded_aps_search_oneshot): the plan
    from the predicted radius (replicated inputs) on the first device, then
    one masked scan, the shards' local scans and the merge. Returns
    (scores, ids, scanned) on the first device."""
    q, pids, boundary, valid, table = _aps_inputs(sharded, q, pids, dimension,
                                                  use_precomputed, table)
    scan_chunk = _local_grouped_chunk(sharded, q, k, metric, qt, group_chunk, kernel, exact)
    return aps_oneshot(q, pids, boundary, valid, table, recall_target, k, metric, dimension,
                       use_precomputed, scan_chunk, sharded.centroids[0], radius_a, radius_b,
                       gamma=gamma, plan_margin=plan_margin, width_clip=width_clip,
                       budget_w=budget_w)


def _normalized(c):
    return c / torch.clamp(torch.linalg.norm(c, dim=1, keepdim=True), min=1e-12)


def sharded_kmeans_step(mesh, x_shards, centroids, metric: str = "l2"):
    """One data-parallel Lloyd iteration (quake_tpu/parallel/sharded.py::
    sharded_kmeans_step): x's rows split over the mesh (a list of per-shard
    blocks, block s on shard s's device), the centroids replicated; each shard assigns
    its rows and sums them per cluster, and the sums and counts are added
    over the shards on the first device. Returns (new centroids on the
    first device, each shard's assignments on its device)."""
    first = mesh.first
    n_clusters, D = centroids.shape
    sums, counts, assigns = [], [], []
    for x_l, d in zip(x_shards, mesh.devices):
        cents = centroids.to(d).to(torch.float32)
        if metric == "ip":
            cents = _normalized(cents)
        xf = x_l.to(torch.float32)
        prod = xf @ cents.T
        if metric == "ip":
            scores = prod
        else:
            scores = (2.0 * prod - torch.sum(xf * xf, dim=1)[:, None]
                      - torch.sum(cents * cents, dim=1)[None, :])
        a = torch.argmax(scores, dim=1).to(torch.int32)
        s = torch.zeros((n_clusters, D), device=d, dtype=torch.float32)
        s.index_add_(0, a.long(), xf)
        c = torch.zeros(n_clusters, device=d, dtype=torch.float32)
        c.index_add_(0, a.long(), torch.ones_like(a, dtype=torch.float32))
        sums.append(s)
        counts.append(c)
        assigns.append(a)
    total, count = _psum(sums, first), _psum(counts, first)
    cents = centroids.to(first).to(torch.float32)
    if metric == "ip":
        cents = _normalized(cents)
    new_c = total / torch.clamp(count[:, None], min=1.0)
    new_c = torch.where((count < 0.5)[:, None], cents, new_c)
    if metric == "ip":
        new_c = _normalized(new_c)
    return new_c, assigns


def sharded_fused_search(sharded, parent_codes, parent_ids, q, k: int, nprobe: int,
                         metric: str, qt: int = 64, group_chunk: int = 64, dedup: bool = False,
                         shard_parents: bool = True, kernel: str = "xla", exact: bool = True):
    """Fixed-nprobe search over a slot-sharded store
    (quake_tpu/parallel/sharded.py::sharded_fused_search): the parent
    ranking, each shard's partition-major grouped scan of its slab slice,
    the merge and the distances.

    shard_parents (where N = the parent's slots divides by ndev and N/ndev
    >= nprobe): each shard ranks its N/ndev of the parent's slots with
    flat_scan(approx=True), and one [B, ndev * nprobe] top-k on the first
    device yields the global candidate ranking (the union of the shards'
    top-nprobe holds the global top-nprobe); else the first device ranks
    them all. Kernel K3 is not on this route, as the JAX package's
    Pallas parent ranking is not. A -1 parent is replaced by the query's
    best (the dense self-heal of coordinator.fused_ivf_search). Each shard
    then runs grouped_scan(..., dense=True) under `kernel`, the name the
    index gives for its global store, with its valid slot counts as sizes;
    the local capacity C/ndev is a 128 multiple where the index sharded the
    store (QuakeIndex.shard).

    Spans: quake.plan.parent, each shard's grouped-scan spans,
    quake.plan.shard_merge and quake.plan.distances.

    Returns (scores, ids32, distances, scanned, probe) on the first
    device."""
    if sharded.strategy != "slot":
        raise ValueError("sharded_fused_search needs the slot strategy (the index routes a "
                         "partition-sharded store through its unfused search)")
    mesh = sharded.mesh
    first, ndev = mesh.first, mesh.size
    Pp, Cp, D = parent_codes.shape
    N = Pp * Cp
    pc_flat = parent_codes.reshape(N, D)
    pi_flat = parent_ids.reshape(N)
    shard_parents = shard_parents and N % ndev == 0 and N // ndev >= nprobe
    with annotate("quake.plan.parent"):
        if shard_parents:
            Nl = N // ndev
            ls, lp = [], []
            for s, d in enumerate(mesh.devices):
                rows = slice(s * Nl, (s + 1) * Nl)
                sc, p = flat_scan(q.to(d), pc_flat[rows].to(d), pi_flat[rows].to(d), nprobe,
                                  metric, approx=True)
                ls.append(sc)
                lp.append(p)
            _, probe = topk_from_scores(_gather(ls, first), _gather(lp, first), nprobe)
        else:
            _, probe = flat_scan(q.to(first), pc_flat.to(first), pi_flat.to(first), nprobe,
                                 metric, approx=True)
        probe = torch.where(probe >= 0, probe, probe[:, :1])
    out_s, out_i, scanned = [], [], []
    for s, d in enumerate(mesh.devices):
        sc, si, n = grouped_scan(sharded.codes[s], sharded.ids[s], sharded.local_sizes[s],
                                 sharded.norms[s], q.to(d), probe.to(d), k, metric, qt,
                                 group_chunk, kernel, dedup=dedup, exact=exact, dense=True)
        out_s.append(sc)
        out_i.append(si)
        scanned.append(n)
    with annotate("quake.plan.shard_merge"):
        ms, mi = _merge_gathered(out_s, out_i, k, first, dedup=dedup)
    dists = scores_to_distances(ms, mi, metric)
    return ms, mi, dists, scanned[0].to(first), probe
