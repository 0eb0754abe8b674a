"""A plain reference of oneshot recall-target (APS) search on an
inner-product index: what `QuakeIndex.search(q, SearchParams(k,
recall_target, aps_mode="oneshot"))` should plan on a calibrated ip index
of unit vectors, in plain PyTorch and float64, with no kernel, cache or
batching of the program.

It is benchmark/aps.py's plan with the candidates ranked by q.c. The rest
is metric-free and taken from there by import: the calibrated state
(`ApsState`), the boundary distances, the recall profile, the depths, the
recall of a plan, the lane columns of kernel K3's fold and the work of a
batch. As the program does (coordinator.aps_setup, aps_oneshot), the
geometry stays in l2 space: an ip build keeps its centroids on the unit
sphere (kmeans.balance_clusters splits at the build's metric), so the
bisector between two candidates is the same plane under either metric, and
the predicted radius a + b d1 takes d1, the l2 distance to the first
ranked candidate; the build fitted a and b to the k-th ip score s_k as the
l2 radius sqrt(|q|^2 + 1 - 2 s_k) (index.py::_calibrate_radius_predictor).

1. the ranked candidates: each query's `width` centroids of largest q.c,
   exact in float64;
2. the boundary distance of each candidate (aps.boundary_distances);
3. the profile, the plan, the pair budget (aps.recall_profile,
   aps.plan_depths);
4. the partitions every sound parent ranking puts within a depth
   (`certain_at_depth`): aps.certain_at_depth on the augmented vectors
   [c, sqrt(R^2 - |c|^2)] and [q, 0] (R the largest centroid norm), whose
   squared l2 distance |q|^2 + R^2 - 2 q.c ranks exactly as q.c does (the
   MIPS-to-NN reduction of Bachrach et al., RecSys 2014).
"""

from __future__ import annotations

import torch

from benchmark import aps


def ranked_candidates(q: torch.Tensor, centroids: torch.Tensor, width: int,
                      block: int = 8192):
    """Each query's `width` centroids of largest q.c, largest first:
    (indexes into `centroids` [B, width] int64, q.c [B, width] float64).
    `centroids`: those of the index's live partitions only."""
    c = centroids.double()
    out_i, out_s = [], []
    for s in range(0, q.shape[0], block):
        sv, si = torch.topk(q[s:s + block].double() @ c.T, width, dim=1)
        out_i.append(si)
        out_s.append(sv)
    return torch.cat(out_i), torch.cat(out_s)


def plan(q: torch.Tensor, centroids: torch.Tensor, state: aps.ApsState, recall_target: float,
         precision: str = "f64", block: int = 2048):
    """The oneshot plan of one batch q [B, D] over the live partitions'
    `centroids`: (candidates [B, M] int64 into `centroids`, depth [B]
    int64, pair budget). The profile of `block` queries at a time (the
    candidates' centroids, [block, M, D] float64, are the memory); the
    depths and the budget over the whole batch. `precision` as
    aps.recall_profile."""
    pids, _ = ranked_candidates(q, centroids, state.width)
    c = centroids.double()
    probs = []
    for s in range(0, q.shape[0], block):
        qb, pb = q[s:s + block], pids[s:s + block]
        cents = c[pb]
        d1 = torch.linalg.vector_norm(qb.double() - cents[:, 0, :], dim=1)
        radius = torch.clamp(state.radius_a + state.radius_b * d1, min=0.0)
        probs.append(aps.recall_profile(aps.boundary_distances(qb, cents), radius,
                                        state.dimension, state.gamma, precision))
    depth, budget = aps.plan_depths(torch.cat(probs), recall_target, state, precision)
    return pids, depth, budget


def augmented(q: torch.Tensor, centroids: torch.Tensor):
    """(q', c'): [q, 0] and [c, sqrt(R^2 - |c|^2)], R the largest centroid
    norm, in float64: |q' - c'|^2 = |q|^2 + R^2 - 2 q.c."""
    c = centroids.double()
    sq = torch.sum(c * c, dim=1)
    extra = torch.sqrt(torch.clamp(sq.max() - sq, min=0.0))
    qa = torch.nn.functional.pad(q.double(), (0, 1))
    return qa, torch.cat([c, extra[:, None]], dim=1)


def certain_at_depth(q: torch.Tensor, centroids: torch.Tensor, depth: torch.Tensor,
                     width: int, lanes=None, fold: int = aps.PARENT_FOLD, block: int = 4096):
    """aps.certain_at_depth by q.c: each query's centroids of largest q.c
    ([m, min(n, 2 width)], indexes of `centroids`) and which of them every
    sound parent ranking puts among its first depth[i], with the
    tolerance of reference.certain_probes (two steps of the coarsest parent
    key over the range of the query's distances, plus float32 rounding) and,
    where `lanes` is given, kernel K3's lane columns."""
    qa, ca = augmented(q, centroids)
    return aps.certain_at_depth(qa, ca, depth, width, lanes, fold, block)
