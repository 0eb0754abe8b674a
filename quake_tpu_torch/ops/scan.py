"""Score conventions, top-k helpers and the scans that run in plain tensor
operations in both packages: the flat scan, the query-major IVF scan and the
duplicate-dropping merge (quake_tpu/ops/scan.py).

Conventions (matching the reference's output semantics):
  * Internally everything is a "score" — higher is better. L2 uses the
    negated *squared* distance; IP uses the raw inner product.
  * Invalid slots/ids carry score -inf and id -1.
  * User-facing L2 distances are sqrt'd (list_scanning.h:260,352-357);
    missing results are padded with id=-1 and +inf (L2) / -inf (IP)
    (query_coordinator.cpp:447-456).
"""

from __future__ import annotations

import torch

from quake_tpu_torch.profiling import annotate

NEG_INF = float("-inf")


def topk_stable(scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken toward the lower index (the
    order `lax.top_k` gives). Returns (values, indices int64)."""
    k = min(int(k), scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_from_scores(scores: torch.Tensor, ids: torch.Tensor, k: int, approx: bool = False):
    """Select top-k by score, gathering ids along. scores [B, M], ids [B, M].
    Ids of -inf entries are squashed to -1 so padding never leaks a
    real-looking id.

    approx=True is where the JAX package switches wide rows (M > 256,
    k <= 128) to `lax.approx_max_k`, a tiled reducer with a recall target of
    0.99 that is exact on the CPU. This package has no approximate reducer:
    such rows take `torch.topk`, an exact top-k (a valid result of the
    approximate one) that leaves the order among equal scores open, where
    every other call breaks ties toward the lower index."""
    k = min(int(k), scores.shape[1])
    if approx and scores.shape[1] > 256 and k <= 128:
        top_scores, idx = torch.topk(scores, k, dim=1)
    else:
        top_scores, idx = topk_stable(scores, k)
    top_ids = torch.gather(ids, 1, idx)
    top_ids = torch.where(top_scores == NEG_INF, torch.full_like(top_ids, -1), top_ids)
    return top_scores, top_ids


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two per-query candidate sets into top-k (higher score = better)
    — the analog of TopkBuffer::batch_add + flush (list_scanning.h:117-173)."""
    return topk_from_scores(torch.cat([scores_a, scores_b], dim=1),
                            torch.cat([ids_a, ids_b], dim=1), k)


def block_scores(q, q_sq, block, block_sq, metric: str):
    """Scores of queries against a block of vectors: q [B, D], block [M, D]
    -> [B, M]."""
    prod = q @ block.T
    if metric == "l2":
        return 2.0 * prod - q_sq[:, None] - block_sq[None, :]
    return prod


def flat_scan(q, codes, ids, k: int, metric: str = "l2", chunk_size: int = 8192,
              approx: bool = False):
    """Top-k of queries against a flat (padded) buffer of vectors
    (quake_tpu/ops/scan.py::flat_scan; the analog of scanning a flat index or
    the parent centroid index, query_coordinator.cpp:624-626).

    q [B, D]; codes [N, D]; ids [N] int32 with -1 = invalid slot. Returns
    (scores [B, k], ids [B, k]). bf16 codes: the queries are rounded to
    bf16 as in the JAX package and multiplied in f32 (a product of two bf16
    values is exact there), never in bf16. Exact by default (the user-facing
    flat index); approx=True marks the parent ranking inside an IVF search
    (see topk_from_scores). A buffer above chunk_size rows is scanned chunk by
    chunk with a running top-k, so the [B, N] score matrix never exists."""
    N = codes.shape[0]
    k = min(int(k), N)
    qf = q.to(codes.dtype).to(torch.float32)  # bf16 codes: the query rounded as they are
    q_sq = torch.sum(qf * qf, dim=1)

    def chunk_topk(block, bids, approx):
        bf = block.to(torch.float32)
        scores = block_scores(qf, q_sq, bf, torch.sum(bf * bf, dim=1), metric)
        scores = torch.where((bids >= 0)[None, :], scores, torch.full_like(scores, NEG_INF))
        return topk_from_scores(scores, bids[None, :].expand(scores.shape), k, approx=approx)

    if N <= chunk_size:
        return chunk_topk(codes, ids, approx)
    best_s = torch.full((q.shape[0], k), NEG_INF, device=q.device, dtype=torch.float32)
    best_i = torch.full((q.shape[0], k), -1, device=q.device, dtype=ids.dtype)
    for c0 in range(0, N, chunk_size):
        s, i = chunk_topk(codes[c0:c0 + chunk_size], ids[c0:c0 + chunk_size], False)
        best_s, best_i = merge_topk(best_s, best_i, s, i, k)
    return best_s, best_i


def ivf_scan(q, pids, codes, ids, sizes, k: int, metric: str = "l2"):
    """Query-major scan of each query's probed partitions, a probe at a time
    (quake_tpu/ops/scan.py::ivf_scan, the analog of batched_serial_scan,
    query_coordinator.cpp:675-799, without grouping the queries).

    q [B, D]; pids [B, nprobe] int32 (-1 = skip); codes [P, C, D]; ids [P, C]
    int32 (-1 = empty slot); sizes is unused: slot validity comes from
    ids >= 0. bf16 codes as in flat_scan. Returns (scores [B, k], ids [B,
    k], partitions scanned [B] int32)."""
    B = q.shape[0]
    qf = q.to(codes.dtype).to(torch.float32)  # bf16 codes: the query rounded as they are
    q_sq = torch.sum(qf * qf, dim=1)
    best_s = torch.full((B, k), NEG_INF, device=q.device, dtype=torch.float32)
    best_i = torch.full((B, k), -1, device=q.device, dtype=ids.dtype)
    n_scanned = torch.zeros(B, device=q.device, dtype=torch.int32)
    for r in range(pids.shape[1]):
        valid = pids[:, r] >= 0
        p = torch.clamp(pids[:, r], min=0).long()
        sf, sids = codes[p].to(torch.float32), ids[p]  # [B, C, D], [B, C]
        prod = torch.bmm(sf, qf[:, :, None])[:, :, 0]
        if metric == "l2":
            scores = 2.0 * prod - q_sq[:, None] - torch.sum(sf * sf, dim=2)
        else:
            scores = prod
        scores = torch.where((sids >= 0) & valid[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        s, i = topk_from_scores(scores, sids, k, approx=True)
        best_s, best_i = merge_topk(best_s, best_i, s, i, k)
        n_scanned = n_scanned + valid.to(torch.int32)
    return best_s, best_i, n_scanned


def duplicate_mask(ids):
    """[B, pool] bool of a [B, pool] id matrix: True where an earlier column
    of the row holds the same id >= 0 (the JAX package's [B, pool, pool]
    comparison of its dedup tails)."""
    pool = ids.shape[1]
    pos = torch.arange(pool, device=ids.device)
    earlier = pos[None, :] < pos[:, None]  # [pool, pool]: column before row
    same = ids[:, :, None] == ids[:, None, :]
    return torch.any(same & earlier[None] & (ids >= 0)[:, :, None], dim=2)


def dedup_topk(scores, ids, k: int):
    """Keep each id's best entry, then top-k (quake_tpu/ops/scan.py::
    dedup_topk: in a spilled store one vector can reach a merged list
    through both of its partitions). scores, ids [B, pool] -> [B, k]; an
    entry is a duplicate when an earlier one holds the same id >= 0."""
    pool = scores.shape[1]
    is_dup = duplicate_mask(ids)
    scores = torch.where(is_dup, torch.full_like(scores, NEG_INF), scores)
    ids = torch.where(is_dup, torch.full_like(ids, -1), ids)
    kfin = min(k, pool)
    scores, ids = topk_from_scores(scores, ids, kfin)
    if kfin < k:
        scores = torch.nn.functional.pad(scores, (0, k - kfin), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kfin), value=-1)
    return scores, ids


def scores_to_distances(scores: torch.Tensor, ids: torch.Tensor, metric: str):
    """Internal scores -> reference-convention distances: L2 = sqrt of the
    squared distance with +inf for missing; IP = raw score with -inf fill
    (query_coordinator.cpp:447-456; list_scanning.h:260). In the span
    quake.plan.distances."""
    with annotate("quake.plan.distances"):
        missing = ids < 0
        if metric == "l2":
            d = torch.sqrt(torch.clamp(-scores, min=0.0))
            return torch.where(missing, torch.full_like(d, float("inf")), d)
        return torch.where(missing, torch.full_like(scores, NEG_INF), scores)


def finalize_result(scores, ids, metric: str):
    """(scores, int32 ids) -> (ids, distances) in reference layout."""
    return ids, scores_to_distances(scores, ids, metric)
