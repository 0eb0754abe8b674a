"""The plain reference: what an IVF index over the benchmark's own vectors
should answer, in plain PyTorch, and the numbers that decide `correct`.

It imports nothing of the program. It reads the program's outputs (answers,
and the partition store the build and the writes left) only to judge them,
and works out its own truth from the inputs the benchmark made: exact
nearest neighbours over the resident vectors, the true distance of every
returned id, each stored vector's norm, each inserted vector's nearest
centroid. Distances and norms are computed in float64 from the inputs as
the configuration stores them (float32, or rounded to bfloat16).

The control is this reference put in the program's place, computed in the
precision just below the configuration's (`CONTROL`): TF32 below float32
(10 mantissa bits, products accumulated in float32), float8 e4m3 below
bfloat16. `round_to` emulates each rounding, so the control reads the same on
any device.
"""

from __future__ import annotations

import contextlib

import torch

# The precision just below a configuration's code precision (the control's).
CONTROL = {"f32": "tf32", "bf16": "fp8"}
CODE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32) rounded to `precision` and returned as float32."""
    x = x.to(torch.float32)
    if precision == "f32":
        return x
    if precision == "tf32":  # 10 mantissa bits: round the 13 dropped bits
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def exact_matmul():
    """float32 products without TF32, whatever the process had set."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def exact_knn(q: torch.Tensor, base: torch.Tensor, k: int, valid=None,
              precision: str = "f32", q_block: int = 4096, b_block: int = 131072):
    """The k nearest (l2) rows of `base` to each query, over the rows where
    `valid` (bool [N]) is set. Returns (ids int64 [m, k], l2 distances
    [m, k], the square roots, as the index returns them). With precision "f32" the candidates are ranked in float32 and
    their distances recomputed in float64 by direct differences; with a lower
    precision (the control) queries and rows are rounded to it, and the
    ranking and the reported distances are those of the rounded arithmetic."""
    lowp = precision != "f32"
    pad = 0 if lowp else 8
    kk = min(k + pad, base.shape[0])
    out_ids, out_d = [], []
    with exact_matmul():
        for qs in range(0, q.shape[0], q_block):
            qb = round_to(q[qs:qs + q_block], precision)
            best_d = torch.full((qb.shape[0], 0), float("inf"), device=q.device)
            best_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=q.device)
            for bs in range(0, base.shape[0], b_block):
                xb = round_to(base[bs:bs + b_block], precision)
                d = _sq(qb)[:, None] + _sq(xb)[None, :] - 2.0 * (qb @ xb.T)
                if valid is not None:
                    d = torch.where(valid[bs:bs + b_block][None, :], d,
                                    torch.full_like(d, float("inf")))
                bd, bi = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
                best_d = torch.cat([best_d, bd], dim=1)
                best_i = torch.cat([best_i, bi + bs], dim=1)
                best_d, sel = torch.topk(best_d, min(kk, best_d.shape[1]), dim=1, largest=False)
                best_i = torch.gather(best_i, 1, sel)
            if not lowp:
                exact = true_dist(q[qs:qs + q_block], base, best_i)
                exact = torch.where(torch.isfinite(best_d), exact,
                                    torch.full_like(exact, float("inf")))
                best_d, sel = torch.sort(exact, dim=1, stable=True)
                best_i = torch.gather(best_i, 1, sel)
            out_ids.append(best_i[:, :k])
            out_d.append(torch.sqrt(torch.clamp(best_d[:, :k], min=0.0)))
    return torch.cat(out_ids), torch.cat(out_d)


def true_dist(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
              block: int = 8192) -> torch.Tensor:
    """float64 squared distance of each query to each of its ids' rows
    ([m, k]; an id outside the rows reads row 0 or the last, and is for the
    caller to mask)."""
    out = []
    for s in range(0, q.shape[0], block):
        idb = torch.clamp(ids[s:s + block], 0, base.shape[0] - 1)
        diff = q[s:s + block, None, :].double() - base[idb].double()
        out.append(torch.sum(diff * diff, dim=-1))
    return torch.cat(out) if out else torch.zeros(ids.shape, dtype=torch.float64)


def dist_err(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
             dists: torch.Tensor) -> float:
    """The widest gap between a returned distance (l2, the square root, as
    the index returns it) squared and the true squared distance of the
    returned id, as a share of |q|^2 + |x|^2, the scale of the rounding in
    |q|^2 + |x|^2 - 2 q.x. Ids that name no row are left to
    `invalid_answers`."""
    ok = (ids >= 0) & (ids < base.shape[0])
    if not bool(ok.any()):
        return 0.0
    truth = true_dist(q, base, ids)
    scale = _sq(q.double())[:, None] + _sq(base[torch.clamp(ids, 0, base.shape[0] - 1)].double())
    gap = (dists.double() ** 2 - truth).abs() / torch.clamp(scale, min=1e-30)
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
    return float(gap[ok].max())


def key_levels(capacity: int) -> int:
    """Levels of the key that ranks a slab of `capacity` rows: a 24-bit
    value exact in float32 holds key * next_pow2(capacity) + row."""
    slot_mult = max(1 << int(capacity - 1).bit_length(), 2)
    return (1 << 24) // slot_mult - 2


def key_scale(q_batch: torch.Tensor, stored: torch.Tensor, capacity: int) -> tuple:
    """(floor, step) of the key's scale for a batch: l2 scores 2 q.x - |x|^2
    lie in [-(max |x|^2 + 2 max |q| max |x|), max |q|^2], a range of
    (max |q| + max |x|)^2, cut into key_levels(capacity) levels."""
    qmax = torch.sqrt(_sq(q_batch.double()).max())
    xmax = torch.sqrt(_sq(stored.double()).max())
    return (float(-(xmax * xmax + 2.0 * qmax * xmax)),
            float((qmax + xmax) ** 2 / key_levels(capacity)))


# Relative error allowed a key's product of the query with a row, as a
# share of sum_d |q_d| |x_d|, by the codes' dtype: bf16 takes the query
# rounded to bf16 (2^-8, bf16's machine epsilon, twice its rounding bound);
# f32 multiplies in 3xTF32 and sums 128 products in float32 (at most
# 128 x 2^-24 = 2^-17 where each sum rounds to nearest; given 2^-14, as the
# tensor cores' float32 sums need not round to nearest).
UNIT_ROUNDOFF = {"f32": 2.0 ** -14, "bf16": 2.0 ** -8}


def dist_budget(q: torch.Tensor, stored: torch.Tensor, ids: torch.Tensor,
                dists: torch.Tensor, step: torch.Tensor, codes: str,
                block: int = 8192) -> float:
    """The widest gap between a returned distance squared and the true
    squared distance to the stored vector, as a share of what serving it
    from a key allows: half a step of the key (`step`, [m, 1]) for its floor
    and dequantization, plus 2 u sum_d |q_d| |x_d| for the query rounded to
    the codes' dtype (unit roundoff u) in the product. A sound answer reads
    at most 1. Ids that name no row are left to `invalid_answers`."""
    ok = (ids >= 0) & (ids < stored.shape[0])
    if not bool(ok.any()):
        return 0.0
    u = UNIT_ROUNDOFF[codes]
    worst = 0.0
    for s in range(0, q.shape[0], block):
        idb = torch.clamp(ids[s:s + block], 0, stored.shape[0] - 1)
        qb, xb = q[s:s + block, None, :].double(), stored[idb].double()
        truth = torch.sum((qb - xb) ** 2, dim=-1)
        allowed = 0.5 * step[s:s + block].double() + 2.0 * u * torch.sum(qb.abs() * xb.abs(), dim=-1)
        gap = (dists[s:s + block].double() ** 2 - truth).abs() / allowed
        gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
        sel = ok[s:s + block]
        if bool(sel.any()):
            worst = max(worst, float(gap[sel].max()))
    return worst


def invalid_answers(ids: torch.Tensor, dists: torch.Tensor, alive: torch.Tensor,
                    k: int) -> int:
    """Answers that break the search's contract: a slot left empty (-1)
    while k vectors are resident, an id that is not resident, an id twice in
    one answer, or distances that fall. An exact count."""
    n_alive = int(alive.sum())
    need = min(k, n_alive)
    ids = ids[:, :k]
    dists = dists[:, :k].double()
    bad = int((ids[:, :need] < 0).sum())
    inside = (ids >= 0) & (ids < alive.shape[0])
    bad += int(((ids >= 0) & ~inside).sum())
    bad += int((inside & ~alive[torch.clamp(ids, 0, alive.shape[0] - 1)]).sum())
    srt = torch.sort(ids, dim=1).values
    bad += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
    both = (ids[:, 1:] >= 0) & (ids[:, :-1] >= 0)
    bad += int((both & (dists[:, 1:] < dists[:, :-1])).sum())
    return bad


def recall(ids: torch.Tensor, truth: torch.Tensor, k: int) -> float:
    """Mean share of each query's true k nearest ids among its k answers."""
    a, t = ids[:, :k], truth[:, :k]
    hit = (a[:, :, None] == t[:, None, :]) & (t[:, None, :] >= 0)
    return float(hit.any(dim=1).sum(dim=1).double().mean() / k)


def valid_slots(ids: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """[P, C] bool: the slots below each partition's size."""
    lane = torch.arange(ids.shape[1], device=ids.device)
    return lane[None, :] < sizes.to(torch.int64)[:, None]


def store_violations(codes, ids, sizes, base, alive, code_dtype) -> int:
    """Exact count of what is wrong in a partition store ([P, C, D] codes,
    [P, C] ids, [P] sizes): a slot below a size without an id or one above
    with one, a resident id held other than exactly once or an id held that
    is not resident, and a stored row not equal to its input vector rounded
    to the code dtype."""
    ids = ids.to(torch.int64)
    valid = valid_slots(ids, sizes)
    bad = int((valid & (ids < 0)).sum()) + int((~valid & (ids >= 0)).sum())
    got = ids[valid & (ids >= 0)]
    inside = got < alive.shape[0]
    bad += int((~inside).sum())
    got_in = got[inside]
    counts = torch.bincount(got_in, minlength=alive.shape[0])
    bad += int((counts != alive.to(counts.dtype)).sum())
    rows = codes[valid & (ids >= 0)][inside]
    want = base[got_in].to(code_dtype)
    bad += int((rows != want).any(dim=1).sum())
    return bad


def stored_rows(ids, sizes):
    """(partition, id) of every filled slot of a store, as int64 tensors."""
    ids = ids.to(torch.int64)
    valid = valid_slots(ids, sizes) & (ids >= 0)
    part = torch.nonzero(valid)[:, 0]
    return part, ids[valid]


def norm_err(norms, ids, sizes, base, code_dtype, precision: str = "f32") -> float:
    """Widest relative gap between the store's cached squared norms and the
    squared norms of its vectors as stored (the inputs rounded to the code
    dtype), in float64. `precision` below the codes' computes the norms to
    judge in that precision instead (the control)."""
    ids = ids.to(torch.int64)
    valid = valid_slots(ids, sizes) & (ids >= 0) & (ids < base.shape[0])
    got = ids[valid]
    if got.numel() == 0:
        return 0.0
    stored = base[got].to(code_dtype).to(torch.float32)
    ref = _sq(stored.double())
    judged = norms[valid].double() if precision == "f32" else _sq(round_to(stored, precision))
    return float(((judged.double() - ref).abs() / torch.clamp(ref, min=1e-30)).max())


def assign_gap(x: torch.Tensor, assigned: torch.Tensor, centroids: torch.Tensor) -> float:
    """Widest excess of a vector's distance to the centroid of the partition
    it was put in over its distance to the nearest centroid, as a share of
    |x|^2 + |c|^2 (0 where every vector went to its nearest centroid).
    `assigned` [m] indexes `centroids`."""
    if x.shape[0] == 0 or centroids.shape[0] == 0:
        return 0.0
    xd, cd = x.double(), centroids.double()
    d = _sq(xd)[:, None] + _sq(cd)[None, :] - 2.0 * (xd @ cd.T)
    da = torch.gather(d, 1, assigned[:, None].to(torch.int64))[:, 0]
    scale = _sq(xd) + _sq(cd[assigned])
    return float(((da - d.min(dim=1).values) / torch.clamp(scale, min=1e-30)).max())


def nearest_centroid(x: torch.Tensor, centroids: torch.Tensor, precision: str = "f32"):
    """Index of each row's nearest centroid, in `precision` (the control's
    assignment)."""
    with exact_matmul():
        xr, cr = round_to(x, precision), round_to(centroids, precision)
        d = _sq(cr)[None, :] - 2.0 * (xr @ cr.T)
    return torch.argmin(d, dim=1)


def certain_probes(q: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                   block: int = 16384):
    """The nprobe nearest centroids of each query ([m, nprobe], indexes of
    `centroids`, ranked in float64) and which of them every sound ranking
    probes too ([m, nprobe] bool): those nearer than the (nprobe+1)-th by
    more than two steps of the coarsest parent key (the query's range of
    centroid distances over key_levels(16384) levels, 16384 the most rows a
    parent key ranks) plus float32 rounding."""
    n = min(nprobe + 1, centroids.shape[0])
    cd = centroids.double()
    out_p, out_ok = [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block].double()
        d = _sq(qb)[:, None] + _sq(cd)[None, :] - 2.0 * (qb @ cd.T)
        dv, di = torch.topk(d, n, dim=1, largest=False)
        ok = torch.ones_like(dv[:, :nprobe], dtype=torch.bool)
        if n > nprobe:
            spread = d.max(dim=1).values - d.min(dim=1).values
            tol = 2.0 * spread / key_levels(16384) + 1e-5 * (_sq(qb) + _sq(cd).max())
            ok = dv[:, :nprobe] < (dv[:, nprobe] - tol)[:, None]
        out_p.append(di[:, :nprobe])
        out_ok.append(ok)
    return torch.cat(out_p), torch.cat(out_ok)


# Lane columns of the scan's fold: of a query's partition, the scan keeps
# the two best keys of each column of rows whose slots agree modulo FOLD,
# then the k best of those (K1 at its fold of 128, the TPU kernel's design).
FOLD = 128


def _fold(v: torch.Tensor, depth: int):
    """The `depth` best values of each lane column of v ([r, n]): (values
    [r, depth, FOLD], -inf where a column has fewer, lanes [r, depth, FOLD])."""
    r, n = v.shape
    cols = -(-n // FOLD)
    v = torch.nn.functional.pad(v, (0, cols * FOLD - n), value=float("-inf"))
    vals, at = torch.topk(v.reshape(r, cols, FOLD), min(depth, cols), dim=1)
    lane = at * FOLD + torch.arange(FOLD, device=v.device)[None, None, :]
    if vals.shape[1] < depth:
        pad = depth - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, 0, 0, pad), value=float("-inf"))
        lane = torch.nn.functional.pad(lane, (0, 0, 0, pad), value=0)
    return vals, lane


def probed_topk(q: torch.Tensor, stored: torch.Tensor, part_ids: list, probes: torch.Tensor,
                certain: torch.Tensor, k: int, rank=None, tol=None, pad: int = 8,
                r_block: int = 4096):
    """The k nearest rows of each query among those it surely scans: the
    rows of the partitions where `certain` holds in its probe list
    (certain_probes). part_ids: one int64 tensor of row ids a partition, in
    its slot order (a row's lane). Ranked in float32 without TF32, the
    candidates' distances recomputed in float64. With `tol` ([m]: a key step
    plus the products' error) only the rows the scan's fold surely keeps
    count: the best of its lane column, or the second, where the third of
    the column scores below it by more than `tol`. With `rank` (keyed_rank)
    the selection is that rank's instead, as the scan selects: the two best
    of each lane column, the top k of those in each partition, then the top
    k of the query's. Returns (ids [m, k] int64, -1 where fewer; their true
    squared distances [m, k] float64 in ascending order, inf where no row)."""
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
                if rank is None:
                    v = (2.0 * (q[r] @ xb.T) - _sq(xb)[None, :]).double()
                else:
                    v = rank(q[r], xb, r)
                lane = None
                if rank is not None or tol is not None:
                    vals, lane = _fold(v, 2 if rank is not None else 3)
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
    d = true_dist(q, stored, cand_i)
    d = torch.where(cand_i >= 0, d, torch.full_like(d, float("inf")))
    d, sel = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
    ids = torch.where(torch.isfinite(d), torch.gather(cand_i, 1, sel), torch.full_like(sel, -1))
    return ids, d


def fold_tol(q: torch.Tensor, stored: torch.Tensor, step: torch.Tensor, codes: str) -> torch.Tensor:
    """[m] the most by which the scan's keys can order two rows against
    their true scores: a key step plus the products' error on both rows
    (2 u |q| max |x| each, UNIT_ROUNDOFF of the codes' dtype), and float32
    rounding of the reference's own scores."""
    qn = torch.sqrt(_sq(q.double()))
    xmax = torch.sqrt(_sq(stored.double()).max())
    u = UNIT_ROUNDOFF[codes]
    return step.double() + 4.0 * u * qn * xmax + 1e-5 * (qn + xmax) ** 2


def keyed_rank(floor: torch.Tensor, step: torch.Tensor, precision: str, slot_mult: int):
    """A rank for probed_topk that keys rows as the scan does, with its
    products in `precision`: the l2 score 2 q.x - |x|^2 of the query and
    the row rounded to it (float32 sums, |x|^2 of the row as stored), cut to
    floor((score - floor) / step) on each query's scale (floor, step: [m]),
    ties to the higher lane."""
    def rank(qb, xb, rows):
        qr, xr = round_to(qb, precision), round_to(xb, precision)
        score = 2.0 * (qr @ xr.T) - _sq(xb)[None, :]
        key = torch.floor((score.double() - floor[rows][:, None]) / step[rows][:, None])
        lane = torch.arange(xb.shape[0], device=xb.device, dtype=torch.float64)
        return torch.clamp(key, min=0.0) * slot_mult + lane[None, :]
    return rank


def sel_budget(q: torch.Tensor, stored: torch.Tensor, ids: torch.Tensor, best_ids: torch.Tensor,
               best_d2: torch.Tensor, step: torch.Tensor, codes: str, block: int = 8192) -> float:
    """The widest excess of the j-th nearest returned row over the j-th of
    the reference's selection (probed_topk: best_ids, best_d2, over the rows
    the query surely scans and the fold surely keeps), in true squared
    distance to the stored vectors, as a share of what a selection by the
    key allows: such a row, left out, lost to every returned one by key, so
    the returned lie within one step of the key's scale (`step`, [m, 1])
    plus the products' error on both rows, 2 u sum_d |q_d| |x_d| each
    (UNIT_ROUNDOFF of the codes' dtype). A sound selection reads under 1.
    An answer short of rows the reference has, or naming no row, reads inf."""
    u = UNIT_ROUNDOFF[codes]
    n = stored.shape[0]
    worst = 0.0
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block, None, :].double()

        def rows(i):
            ok = (i >= 0) & (i < n)
            xb = stored[torch.clamp(i, 0, n - 1)].double()
            d2 = torch.where(ok, torch.sum((qb - xb) ** 2, dim=-1), torch.full(ok.shape, float("inf"),
                             dtype=torch.float64, device=q.device))
            err = torch.where(ok, 2.0 * u * torch.sum(qb.abs() * xb.abs(), dim=-1),
                              torch.zeros_like(d2))
            return torch.sort(d2, dim=1).values, err.max(dim=1).values

        got, err_got = rows(ids[s:s + block])
        _, err_ref = rows(best_ids[s:s + block])
        ref = best_d2[s:s + block]
        gap = torch.where(torch.isfinite(ref), got - ref, torch.full_like(ref, float("-inf")))
        allowed = step[s:s + block].double() + 2.0 * torch.maximum(err_got, err_ref)[:, None]
        worst = max(worst, float((gap / allowed).max()))
    return worst
