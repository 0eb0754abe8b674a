"""A plain reference of oneshot recall-target (APS) search: what
`QuakeIndex.search(q, SearchParams(k, recall_target, aps_mode="oneshot"))`
should plan on a calibrated IVF index, and the recall that plan reaches, in
plain PyTorch and float64, with no kernel, cache or batching of the program.

It takes the build's state as given: the centroids, the partitions' rows,
and the calibrated fields of the recall model (`ApsState`: `aps_dimension`,
`aps_gamma`, the row k-1 of `aps_radius_ab`, the candidate width from
`aps_oneshot_mcap`, `aps_width_clip`, `aps_budget_w`), as a reference of the
fixed-nprobe search takes the build's centroids. From them it computes:

1. the ranked candidates: each query's `width` nearest centroids, exact;
2. the boundary distance of each candidate: the query's distance to the
   bisector of the nearest centroid and the candidate;
3. the cap-volume recall profile (Quake's `compute_recall_profile`,
   geometry.h:345-407) with the exact regularized incomplete beta;
4. the plan: each query's depth from the profile, the margin and the
   rounding, the width clip, and the pair budget scaled over the batch;
5. the recall@k of an exact scan of a plan (`plan_recall`).

What the benchmark adds to the reference: which of a query's planned
partitions every sound parent ranking probes too (`certain_at_depth`, with
the lane columns of kernel K3's fold from `parent_lanes`), and the work of
a batch whose queries scan to depths of their own (`search_work`).

Departures from the published model, each one the program's and kept so
that the reference plans what the program is meant to plan:
- the radius is predicted, not measured: `a + b d1` with d1 the distance to
  the nearest centroid (a and b fitted at build); Quake's APS takes the k-th
  distance found so far;
- the rank-0 candidate's probability is twice the rank-1 one's (`p0 = 2
  p1`) before normalisation, where geometry.h:379 leaves its own rule;
- each probability is raised to `gamma` (fitted at build; 1 leaves it)
  before normalisation;
- where no cap holds mass, all of it goes to rank 0, where geometry.h:397-400
  spreads it evenly;
- masses below float32's smallest normal number count as 0, as the program
  flushes them;
- the cap's argument is x = sqrt((2 R h - h^2) / R^2) in I_x((d+1)/2, 1/2),
  as both of the repository's packages evaluate it (the textbook cap takes x
  without the root); the calibrated dimension is fitted to it;
- the program reads I_x from a 1001-point table with linear interpolation
  (geometry.h:163-211); this reference evaluates it exactly
  (scipy.special.betainc), so a query whose cumulative profile meets the
  target within the table's error may plan one rounding step apart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import betainc

from benchmark import reference, roofline

F32_TINY = float(np.finfo(np.float32).tiny)  # float32's smallest normal number
DEFAULT_FRACTION = 0.02  # the candidate fraction of an uncalibrated width


@dataclass
class ApsState:
    """The calibrated recall model of one index, for one k."""
    dimension: int  # aps_dimension
    gamma: float  # aps_gamma
    radius_a: float  # aps_radius_ab[k - 1, 0]
    radius_b: float  # aps_radius_ab[k - 1, 1]
    width: int  # the candidate width M (aps_oneshot_mcap where set)
    width_clip: int  # aps_width_clip (0: no clip and no budget)
    budget_w: int  # aps_budget_w (0: no budget)
    plan_margin: int = 4  # SearchParams.aps_plan_margin
    plan_round: int = 4

    @classmethod
    def of(cls, index, k: int, plan_margin: int = 4) -> "ApsState":
        """The fields of a built index (any object with the attributes
        below). The width follows the index's rule: aps_oneshot_mcap, else
        aps_plan_width, else 2% of nlist with a floor of 16; never below the
        partitions that hold 2k vectors on average, never above nlist.
        Raises ValueError where the build fitted no radius predictor: the
        index then serves no oneshot plan."""
        if index.aps_radius_ab is None:
            raise ValueError("the index has no calibrated radius predictor (aps_radius_ab)")
        ab = np.asarray(index.aps_radius_ab, dtype=np.float32)
        row = min(max(int(k), 1), ab.shape[0]) - 1
        nlist = int(index.nlist())
        width = int(index.aps_oneshot_mcap or 0) or int(index.aps_plan_width or 0)
        if not width:
            width = max(int(nlist * DEFAULT_FRACTION), min(nlist, 16))
        avg = max(index.ntotal() / max(nlist, 1), 1.0)
        min_parts = min(int(math.ceil(2.0 * k / avg)), nlist)
        width = max(min(width, nlist), min_parts, 1)
        return cls(dimension=int(index.aps_dimension or index.d()),
                   gamma=float(index.aps_gamma), radius_a=float(ab[row, 0]),
                   radius_b=float(ab[row, 1]), width=width,
                   width_clip=int(index.aps_width_clip or 0),
                   budget_w=int(index.aps_budget_w or 0), plan_margin=int(plan_margin))


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def ranked_candidates(q: torch.Tensor, centroids: torch.Tensor, width: int,
                      block: int = 8192):
    """Each query's `width` nearest centroids, nearest first: (indexes into
    `centroids` [B, width] int64, squared distances [B, width] float64),
    |q|^2 + |c|^2 - 2 q.c in float64. `centroids`: those of the index's
    live partitions only."""
    c = centroids.double()
    out_i, out_d = [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block].double()
        d = _sq(qb)[:, None] + _sq(c)[None, :] - 2.0 * (qb @ c.T)
        dv, di = torch.topk(d, width, dim=1, largest=False)
        out_i.append(di)
        out_d.append(torch.clamp(dv, min=0.0))
    return torch.cat(out_i), torch.cat(out_d)


def boundary_distances(q: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[B, M] float64: the distance of each query to the bisector of its
    nearest candidate (column 0 of cents [B, M, D]) and each candidate;
    column 0 holds -1, a placeholder."""
    qd, cd = q.double(), cents.double()
    c0 = cd[:, 0, :]
    v = cd - c0[:, None, :]
    a2 = _sq(v)
    a = torch.sqrt(torch.clamp(a2, min=1e-30))
    d = torch.abs(torch.sum((qd - c0)[:, None, :] * v, dim=2) - 0.5 * a2) / a
    d[:, 0] = -1.0
    return d


def _rounder(precision: str):
    if precision == "f64":
        return lambda t: t
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    return lambda t: t.to(dtype).to(torch.float64)


def recall_profile(boundary: torch.Tensor, radius: torch.Tensor, dimension: int,
                   gamma: float = 1.0, precision: str = "f64") -> torch.Tensor:
    """[B, M] float64: the probability that the nearest neighbour lies in each
    candidate, from the share of the query's ball (radius [B]) that each
    bisector cuts off, in rank order, summing to 1 per query. `precision`
    "bf16" or "f32" rounds every intermediate to that precision (a control
    that computes the profile lower)."""
    r = _rounder(precision)
    b = r(boundary.double())
    R = r(radius.double())[:, None]
    h = r(torch.minimum(torch.clamp(R - b, min=0.0), 2.0 * R))
    Rs = torch.clamp(R, min=1e-30)
    x = r(torch.sqrt(torch.clamp(r(2.0 * Rs * h - h * h) / r(Rs * Rs), 0.0, 1.0)))
    inc = torch.from_numpy(betainc((dimension + 1.0) / 2.0, 0.5, x.cpu().numpy()))
    p = r(0.5 * inc.to(b.device))
    p = torch.where(p >= F32_TINY, p, torch.zeros_like(p))
    finite = torch.isfinite(R) & (R > 0)
    p = torch.where((b < R) & finite, p, torch.zeros_like(p))
    if gamma != 1.0:
        p = r(torch.pow(p, gamma))
        p = torch.where(p >= F32_TINY, p, torch.zeros_like(p))
    if p.shape[1] >= 2:
        p[:, 0] = 2.0 * p[:, 1]
    s = r(torch.sum(p, dim=1, keepdim=True))
    home = torch.zeros_like(p)
    home[:, 0] = 1.0
    fallback = torch.where(finite, home, torch.zeros_like(p))
    return torch.where(s > 0, r(p / torch.clamp(s, min=1e-300)), fallback)


def plan_depths(probs: torch.Tensor, recall_target: float, state: ApsState,
                precision: str = "f64"):
    """(depth [B] int64, pair budget) of a batch from its profiles: the
    smallest n whose ranks before the last, 0 .. n-2, sum to the target (all
    M where none does), plus the margin, up to a multiple of the rounding,
    within [min(round, M), M]; then, where the state has a budget, clipped
    to width_clip and, where the batch's depths pass B budget_w in all,
    each depth's part above the floor scaled down to fit, in integers."""
    B, M = probs.shape
    cum = _rounder(precision)(torch.cumsum(probs, dim=1))
    hit = cum >= recall_target
    first = torch.argmax(hit.to(torch.int64), dim=1)
    n = torch.where(hit.any(dim=1), first + 2, torch.full_like(first, M))
    rnd = int(state.plan_round)
    n = -(-(n + int(state.plan_margin)) // rnd) * rnd
    floor = min(rnd, M)
    n = torch.clamp(n, floor, M)
    budget = 0
    if state.width_clip and state.budget_w:
        n = torch.clamp(n, max=min(int(state.width_clip), M))
        budget = B * max(int(state.budget_w), rnd)
        total = int(n.sum())
        if total > budget:
            avail = max(budget - B * floor, 0)
            denom = max(total - B * floor, 1)
            n = floor + torch.div((n - floor) * avail, denom, rounding_mode="floor")
    return n, budget


def plan(q: torch.Tensor, centroids: torch.Tensor, state: ApsState, recall_target: float,
         precision: str = "f64"):
    """The oneshot plan of one batch q [B, D] over the live partitions'
    `centroids`: (candidates [B, M] int64 into `centroids`, depth [B]
    int64, pair budget). `precision` as recall_profile, applied to the
    profile and its cumulative sum."""
    pids, d2 = ranked_candidates(q, centroids, state.width)
    cents = centroids.double()[pids]
    boundary = boundary_distances(q, cents)
    d1 = torch.sqrt(d2[:, 0])
    radius = torch.clamp(state.radius_a + state.radius_b * d1, min=0.0)
    probs = recall_profile(boundary, radius, state.dimension, state.gamma, precision)
    depth, budget = plan_depths(probs, recall_target, state, precision)
    return pids, depth, budget


def plan_recall(owner: torch.Tensor, pids: torch.Tensor, depth: torch.Tensor) -> float:
    """The recall@k of an exact scan of a plan: the mean share of each
    query's true k nearest that lie in its first depth[b] candidates
    pids[b] ([B, W], indexes of the live partitions). owner [B, k]: the live
    partition (same indexes) that holds each true neighbour."""
    W = pids.shape[1]
    live = torch.arange(W, device=pids.device)[None, :] < depth.to(pids.device)[:, None]
    hit = ((owner[:, :, None] == pids[:, None, :]) & live[:, None, :]).any(dim=2)
    return float(hit.double().mean())


PARENT_FOLD = 128  # the lane columns of the parent ranking's fold (kernel K3)


def parent_lanes(parent_ids: torch.Tensor, live: torch.Tensor, fold: int = PARENT_FOLD):
    """[n] the lane column (slot modulo `fold` in the parent's flat buffer)
    of each live partition, in the order of `live` (the partition ids whose
    centroids the reference ranks); parent_ids [Pp, Cp] (-1 = empty)."""
    flat = parent_ids.reshape(-1).to(torch.int64)
    slot = torch.nonzero(flat >= 0)[:, 0]
    at = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64, device=flat.device)
    at[flat[slot]] = slot % fold
    return at[live.to(flat.device)]


def certain_at_depth(q: torch.Tensor, centroids: torch.Tensor, depth: torch.Tensor,
                     width: int, lanes=None, fold: int = PARENT_FOLD, block: int = 4096):
    """Each query's nearest centroids ([m, min(n, 2 width)], indexes of
    `centroids`, ranked in float64) and which of them every sound parent
    ranking puts among its first depth[i] ([m, same] bool). A sound ranking
    orders two centroids within the tolerance of reference.certain_probes
    (two steps of the coarsest parent key plus float32 rounding) either way
    and, where `lanes` ([n], parent_lanes) is given, keeps only the two best
    of each lane column, as kernel K3 folds the parent's slots. A centroid
    is certain where the fold surely keeps it (at most one other of its
    column lies nearer than it plus the tolerance) and fewer than depth[i]
    centroids the fold may keep lie nearer than it plus the tolerance."""
    c = centroids.double()
    n = c.shape[0]
    wide = min(n, 2 * width)
    if lanes is not None:
        lanes = lanes.to(torch.int64).to(c.device)
        order = torch.argsort(lanes, stable=True)
        count = torch.bincount(lanes, minlength=fold)
        L = int(count.max())
        start = torch.cumsum(count, 0) - count
        rank = torch.arange(n, device=c.device) - start[lanes[order]]
        grid = torch.full((fold, L), -1, dtype=torch.int64, device=c.device)
        grid[lanes[order], rank] = order
        filled = grid >= 0
    out_p, out_ok = [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block].double()
        d = _sq(qb)[:, None] + _sq(c)[None, :] - 2.0 * (qb @ c.T)
        m = d.shape[0]
        spread = d.max(dim=1).values - d.min(dim=1).values
        tol = (2.0 * spread / reference.key_levels(16384) + 1e-5 * (_sq(qb) + _sq(c).max()))
        sure = torch.ones_like(d, dtype=torch.bool)
        maybe = torch.ones_like(d, dtype=torch.bool)
        if lanes is not None:
            col = torch.where(filled[None], d[:, torch.clamp(grid, min=0)],
                              torch.full((m, fold, L), float("inf"), dtype=d.dtype, device=d.device))
            t = tol[:, None, None, None]
            ahead_hi = (col[:, :, None, :] < col[:, :, :, None] + t).sum(dim=-1)
            ahead_lo = (col[:, :, None, :] < col[:, :, :, None] - t).sum(dim=-1)
            sure[:, grid[filled]] = (ahead_hi <= 2)[:, filled]
            maybe[:, grid[filled]] = (ahead_lo <= 1)[:, filled]
        dv, di = torch.sort(d, dim=1)
        maybe_s = torch.gather(maybe, 1, di)
        cum = torch.cumsum(maybe_s.to(torch.int64), dim=1)
        reach = torch.searchsorted(dv.contiguous(), (dv + tol[:, None]).contiguous())
        within = torch.gather(cum, 1, torch.clamp(reach - 1, min=0))
        ahead = torch.where(reach > 0, within, torch.zeros_like(within)) - maybe_s.to(torch.int64)
        dep = depth[s:s + block].to(torch.int64).to(d.device)
        ok = torch.gather(sure, 1, di) & (ahead < dep[:, None])
        out_p.append(di[:, :wide])
        out_ok.append(ok[:, :wide])
    return torch.cat(out_p), torch.cat(out_ok)


def search_work(pids: torch.Tensor, depth: torch.Tensor, sizes: torch.Tensor, d: int, k: int,
                codes: str) -> tuple[float, float]:
    """(operations, bytes) of one batch whose queries scan to depths of their
    own (benchmark/roofline.py's count, each query at its depth): 2 D for
    every (query, vector) pair of the first depth[b] partitions of pids[b]
    and for every (query, centroid) pair of the parent ranking; the scanned
    partitions' codes and cached norms read once (their union over the
    batch), the centroids and the queries (float32) read once, the results
    (an int32 id and a float32 distance each) written once. pids [B, W]
    index `sizes` [nlist], the vectors each partition holds."""
    B, W = pids.shape
    nlist = sizes.shape[0]
    sizes = sizes.to(torch.int64).to(pids.device)
    live = torch.arange(W, device=pids.device)[None, :] < depth.to(pids.device)[:, None]
    p = pids.to(torch.int64)
    pairs = int(torch.where(live, sizes[p], torch.zeros_like(p)).sum())
    flops = 2.0 * d * pairs + 2.0 * d * B * nlist
    touched = torch.zeros(nlist, dtype=torch.bool, device=pids.device)
    touched[p[live]] = True
    rows = int(sizes[touched].sum())
    nbytes = (rows * (d * roofline.CODE_BYTES[codes] + 4) + nlist * d * 4 + B * d * 4
              + B * k * 8)
    return flops, float(nbytes)
