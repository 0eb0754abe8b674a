"""The plain reference of an inner-product index: what an IVF index over the
benchmark's own unit vectors should answer when it ranks by q.x, in plain
PyTorch, and the numbers that decide `correct`.

It imports nothing of the program and reads the program's outputs (answers,
and the partition store the build left) only to judge them, as
benchmark/reference.py does for l2, whose metric-free parts it takes as they
are: the rounding of the control (`round_to`, `CONTROL`), float32 products
without TF32 (`exact_matmul`), the store's contract (`store_violations`),
the cached norms (`norm_err`), recall, the key's levels and the lane columns
of the scan's fold. What changes with the metric is here:

- the truth: the k rows of largest q.x over the resident rows, ranked in
  float32 and scored in float64 (`exact_topk`);
- the served score: the index returns the inner product itself, largest
  first (query_coordinator.cpp:447-456), so `ip_err` is the widest gap of a
  returned score from q.x of the stored row, as a share of |q| |x|;
- the key: kernel K1 ranks a row of an ip index by q.x on the batch's scale
  (ops/grouped_scan.py::global_scale: q_coef = ginv, no norm base), whose
  scores lie in [-max |q| max |x|, max |q| max |x|] (`key_scale`);
- the selection and its budget (`probed_topk`, `keyed_rank`, `sel_budget`),
  by score, largest first;
- the contract of an answer: scores that never rise (`invalid_answers`).
"""

from __future__ import annotations

import torch

from benchmark import reference
from benchmark.reference import UNIT_ROUNDOFF, exact_matmul, key_levels, round_to


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of x (float32) divided by its norm, as Deep1B's base
    vectors are L2-normalized."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-30)


def max_norm(x: torch.Tensor, block: int = 1 << 20) -> float:
    """The largest row norm of x, in float64, a block of rows at a time."""
    out = 0.0
    for s in range(0, x.shape[0], block):
        out = max(out, float(torch.sum(x[s:s + block].double() ** 2, dim=1).max()))
    return out ** 0.5


def true_ip(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
            block: int = 8192) -> torch.Tensor:
    """float64 q.x of each query with each of its ids' rows ([m, k]; an id
    outside the rows reads row 0 or the last, and is for the caller to
    mask)."""
    out = []
    for s in range(0, q.shape[0], block):
        idb = torch.clamp(ids[s:s + block], 0, base.shape[0] - 1)
        out.append(torch.sum(q[s:s + block, None, :].double() * base[idb].double(), dim=-1))
    return torch.cat(out) if out else torch.zeros(ids.shape, dtype=torch.float64)


def exact_topk(q: torch.Tensor, base: torch.Tensor, k: int, precision: str = "f32",
               q_block: int = 4096, b_block: int = 131072):
    """The k rows of `base` of largest inner product with each query.
    Returns (ids int64 [m, k], scores [m, k], largest first, as the index
    returns them). With precision "f32" the candidates are ranked in float32
    (no TF32) and their scores recomputed in float64; with a lower precision
    (the control) queries and rows are rounded to it, and the ranking and
    the reported scores are those of the rounded arithmetic."""
    lowp = precision != "f32"
    kk = min(k + (0 if lowp else 8), base.shape[0])
    out_ids, out_s = [], []
    with exact_matmul():
        for qs in range(0, q.shape[0], q_block):
            qb = round_to(q[qs:qs + q_block], precision)
            best_s = torch.full((qb.shape[0], 0), float("-inf"), device=q.device)
            best_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=q.device)
            for bs in range(0, base.shape[0], b_block):
                s = qb @ round_to(base[bs:bs + b_block], precision).T
                bv, bi = torch.topk(s, min(kk, s.shape[1]), dim=1)
                best_s = torch.cat([best_s, bv], dim=1)
                best_i = torch.cat([best_i, bi + bs], dim=1)
                best_s, sel = torch.topk(best_s, min(kk, best_s.shape[1]), dim=1)
                best_i = torch.gather(best_i, 1, sel)
            if not lowp:
                best_s = true_ip(q[qs:qs + q_block], base, best_i)
                best_s, sel = torch.sort(best_s, dim=1, descending=True, stable=True)
                best_i = torch.gather(best_i, 1, sel)
            out_ids.append(best_i[:, :k])
            out_s.append(best_s[:, :k])
    return torch.cat(out_ids), torch.cat(out_s)


def ip_err(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
           scores: torch.Tensor) -> float:
    """The widest gap between a returned score and q.x of the returned id's
    row, as a share of |q| |x|, the scale of a product's rounding. Ids that
    name no row are left to `invalid_answers`."""
    ok = (ids >= 0) & (ids < base.shape[0])
    if not bool(ok.any()):
        return 0.0
    truth = true_ip(q, base, ids)
    xn = torch.linalg.vector_norm(base[torch.clamp(ids, 0, base.shape[0] - 1)].double(), dim=-1)
    scale = torch.linalg.vector_norm(q.double(), dim=1)[:, None] * xn
    gap = (scores.double() - truth).abs() / torch.clamp(scale, min=1e-30)
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
    return float(gap[ok].max())


def invalid_answers(ids: torch.Tensor, scores: torch.Tensor, alive: torch.Tensor,
                    k: int) -> int:
    """reference.invalid_answers with scores for distances: a slot left
    empty while k vectors are resident, an id not resident, an id twice in
    one answer, or a score that rises. An exact count."""
    return reference.invalid_answers(ids, -scores.double(), alive, k)


def key_scale(q_batch: torch.Tensor, xmax: float, capacity: int) -> tuple:
    """(floor, step) of K1's key scale for a batch of an ip index: scores
    q.x lie in [-max |q| max |x|, max |q| max |x|], a range of
    2 max |q| max |x|, cut into key_levels(capacity) levels. xmax: the
    largest stored row's norm (max_norm)."""
    qmax = float(torch.sqrt(torch.sum(q_batch.double() ** 2, dim=1).max()))
    return -qmax * xmax, 2.0 * qmax * xmax / key_levels(capacity)


def probed_topk(q: torch.Tensor, stored: torch.Tensor, part_ids: list, probes: torch.Tensor,
                certain: torch.Tensor, k: int, rank=None, tol=None, pad: int = 8,
                r_block: int = 4096):
    """reference.probed_topk by inner product: the k rows of largest q.x of
    each query among those it surely scans (the partitions where `certain`
    holds in its probe list), with `tol` only the rows the scan's fold
    surely keeps (the best of its lane column, or the second, where the
    third scores below it by more than tol), and with `rank` (keyed_rank)
    the scan's key selection instead. Ranked in float32 without TF32, the
    candidates' scores recomputed in float64. Returns (ids [m, k] int64, -1
    where fewer; their q.x [m, k] float64, largest first, -inf where no
    row)."""
    m, nprobe = probes.shape
    dev = q.device
    keep = k if rank is not None else k + pad
    cand_i = torch.full((m, nprobe * keep), -1, dtype=torch.int64, device=dev)
    cand_v = torch.full((m, nprobe * keep), float("-inf"), dtype=torch.float64, device=dev)
    with exact_matmul():
        for p in torch.unique(probes[certain]).tolist():
            rows, col = torch.nonzero((probes == p) & certain, as_tuple=True)
            ids_p = part_ids[p]
            if ids_p.numel() == 0:
                continue
            xb = stored[ids_p]
            n = min(keep, ids_p.shape[0])
            slot = torch.arange(n, device=dev)
            for s in range(0, rows.shape[0], r_block):
                r, c = rows[s:s + r_block], col[s:s + r_block]
                v = (q[r] @ xb.T).double() if rank is None else rank(q[r], xb, r)
                lane = None
                if rank is not None or tol is not None:
                    vals, lane = reference._fold(v, 2 if rank is not None else 3)
                    if rank is None:
                        t = tol[r].double()[:, None]
                        third = vals[:, 2]
                        vals = torch.stack([torch.where(third <= vals[:, 0] - t, vals[:, 0], -torch.inf),
                                            torch.where(third <= vals[:, 1] - t, vals[:, 1], -torch.inf)], 1)
                        lane = lane[:, :2]
                    v, lane = vals.reshape(r.shape[0], -1), lane.reshape(r.shape[0], -1)
                tv, ti = torch.topk(v, n, dim=1)
                if lane is not None:
                    ti = torch.gather(lane, 1, ti)
                at = (c * keep)[:, None] + slot[None, :]
                cand_v[r[:, None], at] = tv.double()
                got = torch.where(torch.isfinite(tv), ids_p[torch.clamp(ti, max=ids_p.shape[0] - 1)],
                                  torch.full_like(ti, -1))
                cand_i[r[:, None], at] = got
    if rank is not None:
        _, sel = torch.topk(cand_v, min(k, cand_v.shape[1]), dim=1)
        cand_i = torch.gather(cand_i, 1, sel)
    s = true_ip(q, stored, cand_i)
    s = torch.where(cand_i >= 0, s, torch.full_like(s, float("-inf")))
    s, sel = torch.topk(s, min(k, s.shape[1]), dim=1)
    ids = torch.where(torch.isfinite(s), torch.gather(cand_i, 1, sel), torch.full_like(sel, -1))
    return ids, s


def keyed_rank(floor: torch.Tensor, step: torch.Tensor, precision: str, slot_mult: int):
    """A rank for probed_topk that keys rows as K1 keys an ip index, with
    its products in `precision`: q.x of the query and the row rounded to it
    (float32 sums), cut to floor((score - floor) / step) on each query's
    scale (floor, step: [m]), ties to the higher lane."""
    def rank(qb, xb, rows):
        score = round_to(qb, precision) @ round_to(xb, precision).T
        key = torch.floor((score.double() - floor[rows][:, None]) / step[rows][:, None])
        lane = torch.arange(xb.shape[0], device=xb.device, dtype=torch.float64)
        return torch.clamp(key, min=0.0) * slot_mult + lane[None, :]
    return rank


def sel_budget(q: torch.Tensor, stored: torch.Tensor, ids: torch.Tensor, best_ids: torch.Tensor,
               best_s: torch.Tensor, step: torch.Tensor, codes: str, block: int = 8192) -> float:
    """The widest shortfall of the j-th best returned row's q.x under the
    j-th of the reference's selection (probed_topk: best_ids, best_s), in
    q.x of the stored rows, as a share of what a selection by the key
    allows: such a row, left out, lost to every returned one by key, so the
    returned lie within one step of the key's scale (`step`, [m, 1]) plus
    the products' error on both rows, u sum_d |q_d| |x_d| each (u of the
    codes' dtype, reference.UNIT_ROUNDOFF: twice the rounding of the query
    to bf16 in K1's bf16 body). A sound selection reads under 1. An answer
    short of rows the reference has, or naming no row, reads inf."""
    u = UNIT_ROUNDOFF[codes]
    n = stored.shape[0]
    worst = 0.0
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block, None, :].double()

        def rows(i):
            ok = (i >= 0) & (i < n)
            xb = stored[torch.clamp(i, 0, n - 1)].double()
            v = torch.where(ok, torch.sum(qb * xb, dim=-1), torch.full(ok.shape, float("-inf"),
                            dtype=torch.float64, device=q.device))
            err = torch.where(ok, u * torch.sum(qb.abs() * xb.abs(), dim=-1), torch.zeros_like(v))
            return torch.sort(v, dim=1, descending=True).values, err.max(dim=1).values

        got, err_got = rows(ids[s:s + block])
        _, err_ref = rows(best_ids[s:s + block])
        ref = best_s[s:s + block]
        gap = torch.where(torch.isfinite(ref), ref - got, torch.full_like(ref, float("-inf")))
        allowed = step[s:s + block].double() + 2.0 * torch.maximum(err_got, err_ref)[:, None]
        worst = max(worst, float((gap / allowed).max()))
    return worst
