"""Score conventions and exact top-k helpers (the main-path part of
quake_tpu/ops/scan.py).

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

NEG_INF = float("-inf")


def topk_stable(scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken toward the lower index (the
    order `lax.top_k` gives). Returns (values, indices int64)."""
    k = min(int(k), scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_from_scores(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Select top-k by score, gathering ids along. scores [B, M], ids [B, M].
    Ids of -inf entries are squashed to -1 so padding never leaks a
    real-looking id."""
    top_scores, idx = topk_stable(scores, k)
    top_ids = torch.gather(ids, 1, idx)
    top_ids = torch.where(top_scores == NEG_INF, torch.full_like(top_ids, -1), top_ids)
    return top_scores, top_ids


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two per-query candidate sets into top-k (higher score = better)
    — the analog of TopkBuffer::batch_add + flush (list_scanning.h:117-173)."""
    return topk_from_scores(torch.cat([scores_a, scores_b], dim=1),
                            torch.cat([ids_a, ids_b], dim=1), k)


def scores_to_distances(scores: torch.Tensor, ids: torch.Tensor, metric: str):
    """Internal scores -> reference-convention distances: L2 = sqrt of the
    squared distance with +inf for missing; IP = raw score with -inf fill
    (query_coordinator.cpp:447-456; list_scanning.h:260)."""
    missing = ids < 0
    if metric == "l2":
        d = torch.sqrt(torch.clamp(-scores, min=0.0))
        return torch.where(missing, torch.full_like(d, float("inf")), d)
    return torch.where(missing, torch.full_like(scores, NEG_INF), scores)


def finalize_result(scores, ids, metric: str):
    """(scores, int32 ids) -> (ids, distances) in reference layout."""
    return ids, scores_to_distances(scores, ids, metric)
