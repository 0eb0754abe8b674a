"""Search execution (quake_tpu/coordinator.py): the flat and the query-major
searches, parent ranking, the dense-pid self-heal, the grouped-scan dispatch
by kernel name, the distance conversion, and recall-target (APS) search.

APS early termination — a host polling loop in the reference
(query_coordinator.cpp:383-430), a `lax.while_loop` in the JAX package — is
a host loop here (aps_loop) that reads one flag from the device a step. The
planned and oneshot strategies plan every query's probe count from the
recall model and scan once or twice without reading anything back: their
pair budget is a Python int.
"""

from __future__ import annotations

import os
import re

import torch

from quake_tpu_torch import geometry
from quake_tpu_torch.ops.flat_topk import MAX_N, parent_rank
from quake_tpu_torch.ops.grouped import group_layout, grouped_scan_xla
from quake_tpu_torch.ops.grouped_chunked import (grouped_scan_v4, grouped_scan_v5,
                                                 grouped_scan_v6)
from quake_tpu_torch.ops.grouped_exact import grouped_scan_v2, grouped_scan_v3
from quake_tpu_torch.ops.grouped_family import (grouped_scan_v3p, grouped_scan_v3pn,
                                                grouped_scan_v7, grouped_scan_v8)
from quake_tpu_torch.ops.grouped_scan import (FOLD, budget_sort_key_fits, check_fold,
                                              grouped_scan_v10, grouped_scan_v10b,
                                              grouped_scan_v11, sort_key_fits)
from quake_tpu_torch.ops.scan import (NEG_INF, dedup_topk, flat_scan, ivf_scan, merge_topk,
                                      scores_to_distances, topk_from_scores)
from quake_tpu_torch.profiling import annotate


def flat_search(codes, ids, q, k: int, metric: str, chunk_size: int = 16384,
                approx: bool = False):
    """Scan every slot of the store (a flat index, or the parent centroid
    index; query_coordinator.cpp:624-626). codes [P, C, D], ids [P, C].
    approx=True marks a parent ranking (see ops/scan.py::topk_from_scores);
    the user-facing flat search stays exact. Returns (scores, ids)."""
    P, C, D = codes.shape
    return flat_scan(q, codes.reshape(P * C, D), ids.reshape(P * C), k, metric, chunk_size,
                     approx=approx)


def ivf_search(codes, ids, q, pids, k: int, metric: str):
    """Fixed-nprobe query-major scan of each query's probed partitions
    (the batched_serial_scan analog, query_coordinator.cpp:675-799). Returns
    (scores, ids, scanned)."""
    return ivf_scan(q, pids, codes, ids, None, k, metric)


def fused_flat_search(codes, ids, q, k: int, metric: str, chunk_size: int = 16384):
    """Flat search and distance conversion. Returns (scores, ids32,
    distances)."""
    scores, ids32 = flat_search(codes, ids, q, k, metric, chunk_size)
    return scores, ids32, scores_to_distances(scores, ids32, metric)


def rank_parents(parent_codes, parent_ids, parent_norms, q, nprobe: int,
                 metric: str, parent_kernel: str = "approx"):
    """Ranked candidate partitions (the recursive parent search,
    query_coordinator.cpp:628-646). parent_kernel: "approx" = the flat scan
    with approx=True (a product and a top-k in tensor operations); "pallas"
    (the JAX package's name for its fused kernel) = kernel K3
    (ops/flat_topk.py), which ranks by a quantized key. Outside K3's
    preconditions (cached norms, N % 128 == 0, N <= 16384) "pallas" falls
    back to "approx", as in the JAX package."""
    Pp, Cp, D = parent_codes.shape
    N = Pp * Cp
    if (parent_kernel == "pallas" and parent_norms is not None and N % FOLD == 0
            and N <= MAX_N):
        return parent_rank(parent_codes, parent_ids, parent_norms, q, nprobe, metric)
    _, pids = flat_scan(q, parent_codes.reshape(N, D), parent_ids.reshape(N), nprobe, metric,
                        approx=True)
    return pids


def reference_scan(codes, ids, norms, q, pids, k: int, metric: str,
                   max_bytes: int = 1 << 28):
    """Plain exact reference of the grouped scan: every query scores all
    slots of its probed partitions and keeps an exact top-k. bf16 codes are
    upcast and scored against the f32 query, as the exact rescore scores
    them. Chunked over queries so the gathered slabs stay below max_bytes.
    Returns (scores, ids int32, scanned)."""
    B, nprobe = pids.shape
    P, C, D = codes.shape
    qf = q.to(torch.float32)
    step = max(1, max_bytes // max(nprobe * C * D * 4, 1))
    out_s, out_i = [], []
    for b0 in range(0, B, step):
        pb = pids[b0:b0 + step].long()
        ok = pb >= 0
        safe = torch.clamp(pb, min=0)
        slab = codes[safe].reshape(pb.shape[0], nprobe * C, D).to(torch.float32)
        sid = torch.where(ok[:, :, None], ids[safe], torch.full_like(ids[safe], -1))
        sid = sid.reshape(pb.shape[0], nprobe * C)
        qb = qf[b0:b0 + step]
        prod = torch.bmm(slab, qb[:, :, None])[:, :, 0]
        if metric == "l2":
            sc = (2.0 * prod - torch.sum(qb * qb, dim=1, keepdim=True)
                  - norms[safe].reshape(pb.shape[0], nprobe * C))
        else:
            sc = prod
        sc = torch.where(sid >= 0, sc, torch.full_like(sc, NEG_INF))
        s, i = topk_from_scores(sc, sid, k)
        out_s.append(s)
        out_i.append(i)
    scanned = torch.sum((pids >= 0).to(torch.int32), dim=1, dtype=torch.int32)
    return torch.cat(out_s), torch.cat(out_i).to(torch.int32), scanned


_FOLDED = re.compile(r"(v7|v8|v9|v10|v11)(?:g(\d+))?(?:f(\d+))?$")
_V3PN = re.compile(r"v3p(\d+)$")
CHUNK_SIZES = (512, 384, 256, 128)  # preferred chunk heights of v4/v5/v6, in order


def chunk_spec(kernel: str, C: int, gpb: int):
    """(ct, gpb) of a v4/v5/v6 name: "v4", "v4c{ct}" or "v4c{ct}g{gpb}". A
    missing ct, or one that does not divide C, becomes the first of
    CHUNK_SIZES that divides C, else the whole slab (ct = C)."""
    ct = 0
    if len(kernel) > 2:
        spec = kernel[3:]
        if "g" in spec:
            cts, gs = spec.split("g")
            ct, gpb = int(cts), int(gs)
        else:
            ct = int(spec)
    if not ct or C % ct:
        ct = next((c for c in CHUNK_SIZES if C % c == 0), C)
    return ct, gpb


def grouped_scan(codes, ids, sizes, norms, q, pids, k: int, metric: str,
                 qt: int, group_chunk: int, kernel: str, dedup: bool = False,
                 dense: bool = False, exact: bool = True, pair_budget: int = 0):
    """Grouped-scan dispatch by name (quake_tpu/coordinator.py::grouped_scan).

    "v4", "v5" and "v6", each with an optional "c{ct}" and "g{gpb}", run
    the size-aware chunked scans (v4 and v6 on kernel K4, v5 on K7); "v3p"
    runs v3p (K4); "v3p{N}" runs v3pN with gpb=N (K4); "v7", "v8", "v9",
    "v10" and "v11", each with an optional "g{gpb}" and "f{fold}", run v7 (K5), v8
    (K1 + K2; v9 too), v10 (K1 + the scatter placement + K2) and v11 (K1 +
    the sorted or argsort placement + K2); "v3" and "v2" run the exact-score
    scans (K6); "reference" runs the plain exact scan; any other name, "xla"
    included, runs grouped_scan_xla, `group_chunk` groups at a time. As in
    the JAX package, a folded name falls back to v3pN with its gpb when
    C % fold != 0. The fold reaches kernels K1 (v8-v11, v10b) and K5 (v7)
    on every device; the pool merge K2 keeps 128, as in the JAX package.
    The folds served are 32, 64 and the multiples of 128
    (ops/grouped_scan.py::fold_served); any other fold that divides C
    raises ValueError naming them (the JAX kernels run it in interpret mode
    only). dense promises that every pid is valid (fixed-nprobe
    semantics); v11 needs it and rides v10 without it. The v11 placement is
    sorted while its uint32 key fits, else argsort, or v10 where
    QUAKE_TPU_V11_OVERFLOW=v10; QUAKE_TPU_V11_PLACEMENT=argsort forces
    argsort where the key fits (both read at each call, as in the JAX
    package). dedup (a spilled store: each vector in two
    partitions, no id twice in a result row) reaches every scan's tail as
    in the JAX package (v10/v11 take the general pool tail, without kernel
    K2); v2, v3 and v3p raise the JAX package's ValueError. exact=False
    (dequantized scores) reaches v10 and v11 only; every other name rescores
    exactly, as in the JAX package. bf16 codes run on every name, each
    kernel on its bf16 body (the query tiles rounded to bf16 as the JAX
    wrappers round them: q * q_coef for v8-v11, q itself for the others).
    pair_budget > 0 (a masked, not dense, v10 or v11 request whose C the
    fold divides) runs the budgeted scan, grouped_scan_v10b: v11 with the
    sorted placement where its key fits uint32 (budget_sort_key_fits), else
    the scatter one. The caller guarantees at most pair_budget valid pids;
    every other name ignores the budget, as in the JAX package."""
    if kernel == "reference":
        if dedup:
            scores, out_ids, scanned = reference_scan(codes, ids, norms, q, pids, 2 * k, metric)
            return (*dedup_topk(scores, out_ids, k), scanned)
        return reference_scan(codes, ids, norms, q, pids, k, metric)
    if kernel[:2] in ("v4", "v5", "v6"):
        fn, gpb = {"v4": (grouped_scan_v4, 8), "v5": (grouped_scan_v5, 4),
                   "v6": (grouped_scan_v6, 4)}[kernel[:2]]
        ct, gpb = chunk_spec(kernel, codes.shape[1], gpb)
        return fn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt, ct=ct, gpb=gpb,
                  dedup=dedup)
    if dedup and kernel in ("v2", "v3", "v3p"):
        raise ValueError(
            f"kernel {kernel!r} does not support dedup (spilled stores); "
            "use the default v3pN, v4, v5/v6, v7, or xla backends")
    m = _FOLDED.match(kernel)
    if m is not None:
        name, gpb, fold = m.group(1), int(m.group(2) or 4), int(m.group(3) or FOLD)
        if codes.shape[1] % fold:
            return grouped_scan_v3pn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                     gpb=gpb, dedup=dedup)
        check_fold(kernel, fold, codes.shape[1])
        if pair_budget > 0 and not dense and name in ("v10", "v11"):
            placement = ("sorted" if name == "v11" and budget_sort_key_fits(
                q.shape[0], pids.shape[1], pair_budget, codes.shape[0], qt, gpb) else "scatter")
            return grouped_scan_v10b(codes, ids, sizes, norms, q, pids, k, metric,
                                     pair_budget=pair_budget, qt=qt, gpb=gpb, fold=fold,
                                     dedup=dedup, exact=exact, placement=placement)
        if name == "v11" and not dense:
            name = "v10"  # masked pid matrices ride the scatter placement
        placement = "sorted"
        if name == "v11":
            B, nprobe = pids.shape
            rows = -(-group_layout(B, nprobe, codes.shape[0], qt) // gpb) * gpb * qt
            if not sort_key_fits(B, rows):
                if os.environ.get("QUAKE_TPU_V11_OVERFLOW", "argsort") == "v10":
                    name = "v10"
                else:
                    placement = "argsort"
            if os.environ.get("QUAKE_TPU_V11_PLACEMENT") == "argsort":
                placement = "argsort"
        if name == "v7":
            return grouped_scan_v7(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                   gpb=gpb, fold=fold, dedup=dedup)
        if name in ("v8", "v9"):  # v9 computes v8's function (grouped_family.py)
            return grouped_scan_v8(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                   gpb=gpb, fold=fold, dedup=dedup)
        if name == "v10":
            return grouped_scan_v10(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                    gpb=gpb, fold=fold, dedup=dedup, exact=exact)
        return grouped_scan_v11(codes, ids, sizes, norms, q, pids, k, metric,
                                qt=qt, gpb=gpb, fold=fold, dedup=dedup, exact=exact,
                                placement=placement)
    m = _V3PN.match(kernel)
    if m is not None:
        return grouped_scan_v3pn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                 gpb=int(m.group(1)), dedup=dedup)
    if kernel == "v3p":
        return grouped_scan_v3p(codes, ids, sizes, norms, q, pids, k, metric, qt=qt)
    if kernel == "v3":
        return grouped_scan_v3(codes, ids, sizes, norms, q, pids, k, metric, qt=qt)
    if kernel == "v2":
        return grouped_scan_v2(codes, ids, q, pids, k, metric, qt=qt)
    return grouped_scan_xla(codes, ids, q, pids, k, metric, qt=qt, group_chunk=group_chunk,
                            norms=norms, dedup=dedup)


def fused_ivf_search(codes, ids, sizes, norms, parent_codes, parent_ids, q,
                     k: int, nprobe: int, metric: str, qt: int,
                     kernel: str = "v11g4", parent_norms=None, group_chunk: int = 64,
                     parent_kernel: str = "approx", exact: bool = True,
                     dedup: bool = False):
    """End-to-end fixed-nprobe search: parent centroid ranking -> grouped
    scan -> top-k merge -> distance conversion. exact=False: dequantized
    scores on v10 and v11; dedup: the spilled store's tail (see
    grouped_scan). All launches go to the current stream; nothing
    synchronises. Each stage runs in a span (quake.plan.parent, then the
    grouped scan's; see quake_tpu_torch.profiling).

    Returns (scores, ids32, distances, scanned, pids)."""
    with annotate("quake.plan.parent"):
        pids = rank_parents(parent_codes, parent_ids, parent_norms, q, nprobe, metric,
                            parent_kernel)
        # Self-heal the dense invariant: a -1 pid would drop its pair from the
        # grouping and shift the sorted placement's windows for every query.
        # Substitute the query's best (always-valid) parent; duplicates collapse
        # downstream.
        pids = torch.where(pids >= 0, pids, pids[:, :1])
    scores, ids32, scanned = grouped_scan(codes, ids, sizes, norms, q, pids, k,
                                          metric, qt, group_chunk, kernel, dedup=dedup,
                                          dense=True, exact=exact)
    dists = scores_to_distances(scores, ids32, metric)
    return scores, ids32, dists, scanned, pids


# ------------------------------------------------------------------ APS


def aps_setup(q, centroids, pids, dimension: int, use_precomputed: bool, table):
    """Shared APS preamble (quake_tpu/coordinator.py::aps_setup): per-candidate
    Voronoi boundary distances and the beta lookup table. Returns (boundary
    [B, M], valid [B, M], table).

    APS geometry always works in L2 space: for IP, spherical k-means keeps
    centroids unit-norm, so the k-th IP score s maps to an L2 radius
    sqrt(|q|^2 + 1 - 2 s) (the MIPS -> NN reduction on a ~unit-norm corpus).
    Runs in the span quake.aps.setup."""
    with annotate("quake.aps.setup"):
        valid = pids >= 0
        cents = centroids[torch.where(valid, pids, torch.zeros_like(pids)).long()]
        boundary = geometry.boundary_distances(q.to(torch.float32), cents, "l2")
        col0 = boundary[:, 0].clone()
        boundary = torch.where(valid, boundary, torch.full_like(boundary, float("inf")))
        boundary[:, 0] = col0
        if use_precomputed and table is None:
            table = geometry.beta_table(dimension, "l2", q.device)
    return boundary, valid, table


def _radius(kth, q, metric: str):
    """The k-th score as an L2 radius (inf while the top-k is not full)."""
    if metric == "l2":
        r = torch.sqrt(torch.clamp(-kth, min=0.0))
    else:
        q_sq = torch.sum(q.to(torch.float32) ** 2, dim=1)
        r = torch.sqrt(torch.clamp(q_sq + 1.0 - 2.0 * kth, min=0.0))
    return torch.where(torch.isfinite(kth), r, torch.full_like(r, float("inf")))


def _plan_depth(probs, recall_target: float):
    """n_b = the smallest n whose exclusive cumulative probability sum_{i <
    n-1} probs_i reaches the target (cs[j] = sum_{i <= j}: met at n = j + 2),
    M where none does. int64 [B]. argmax runs on int32: CUDA has no argmax of
    bool; both return the first maximal index, as jnp.argmax does."""
    M = probs.shape[1]
    hit = torch.cumsum(probs, dim=1) >= recall_target
    first = torch.argmax(hit.to(torch.int32), dim=1)
    return torch.where(hit.any(dim=1), first + 2, torch.full_like(first, M))


def _ceil_to(x, r: int):
    return torch.div(x + (r - 1), r, rounding_mode="floor") * r


def aps_loop(q, pids, boundary, valid, table, recall_target, recompute_threshold, k: int,
             metric: str, dimension: int, chunk: int, use_precomputed: bool, scan_chunk,
             gamma=None, stats=None):
    """The APS loop core (quake_tpu/coordinator.py::aps_loop).
    `scan_chunk(eff)` scans a [B, chunk] pid matrix (-1 = skip) and returns
    per-query (scores [B, k], ids [B, k]).

    Each step scans the next `chunk` ranked partitions of the queries still
    active, merges, recomputes the recall profile of the queries whose
    radius moved by more than recompute_threshold (relative), and retires
    the queries whose cumulative probability of the ranks before the last
    scanned one reaches the target (the reference's exclusive convention,
    query_coordinator.cpp:573-576). The JAX package's lax.while_loop is a
    host loop here: before every step after the first it reads
    `active.any()` from the device (one sync; the first step needs none, as
    every query starts active). Each step's radius, profile and retirement
    run in the span quake.aps.plan. `stats`, a dict when given, gets
    "steps" (the steps run) and "syncs" (the device reads) added.

    Reference: query_coordinator.cpp:383-430 (worker path) / :537-579
    (serial path). Returns (scores [B, k], ids [B, k], scanned [B] int32)."""
    B, M = pids.shape
    n_chunks = -(-M // chunk)
    pids_p = torch.nn.functional.pad(pids, (0, n_chunks * chunk - M), value=-1)
    dev = q.device
    rank_idx = torch.arange(M, device=dev)[None, :]
    scores = torch.full((B, k), NEG_INF, device=dev, dtype=torch.float32)
    sids = torch.full((B, k), -1, device=dev, dtype=torch.int32)
    radius = torch.full((B,), 1.0e6, device=dev, dtype=torch.float32)  # serial_scan :523
    probs = torch.zeros((B, M), device=dev, dtype=torch.float32)
    active = torch.ones(B, device=dev, dtype=torch.bool)
    scanned = torch.zeros(B, device=dev, dtype=torch.int32)
    steps = syncs = 0
    for i in range(n_chunks):
        if i > 0:
            syncs += 1
            if not bool(active.any()):
                break
        eff = torch.where(active[:, None], pids_p[:, i * chunk:(i + 1) * chunk],
                          torch.full_like(pids_p[:, :chunk], -1))
        n_new = torch.sum((eff >= 0).to(torch.int32), dim=1, dtype=torch.int32)
        s, si = scan_chunk(eff)
        scores, sids = merge_topk(scores, sids, s, si.to(sids.dtype), k)
        with annotate("quake.aps.plan"):
            radius_new = _radius(scores[:, k - 1], q, metric)
            rel = torch.abs(radius_new - radius) / torch.clamp(torch.abs(radius_new), min=1e-30)
            recompute = (rel > recompute_threshold) & active
            probs_new = geometry.recall_profile(boundary, radius_new, dimension, "l2",
                                                use_precomputed, table, valid, gamma=gamma)
            probs = torch.where(recompute[:, None], probs_new, probs)
            radius = torch.where(recompute, radius_new, radius)
            ranks_scanned = min((i + 1) * chunk, M)
            cum = torch.sum(torch.where(rank_idx < ranks_scanned - 1, probs,
                                        torch.zeros_like(probs)), dim=1)
            active = active & (cum < recall_target)
        scanned = scanned + n_new
        steps += 1
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
        stats["syncs"] = stats.get("syncs", 0) + syncs
    return scores, sids, scanned


def aps_search(codes, ids, centroids, q, pids, recall_target, recompute_threshold, k: int,
               metric: str, dimension: int, chunk: int = 4, use_precomputed: bool = True,
               table=None, qt: int = 32, kernel: str = "xla", sizes=None, norms=None,
               gamma=None, small_batch=None, exact: bool = True, stats=None):
    """Adaptive partition scan with recall-target early termination
    (quake_tpu/coordinator.py::aps_search): aps_loop over `chunk` ranked
    partitions a step, each step a masked partition-major grouped scan
    (`kernel` by name, see grouped_scan), or with small_batch=True the
    query-major ivf_scan (the JAX package's opt-in knob; None means False).

    pids: [B, M] candidate partitions in rank order (-1 = pad). Returns
    (scores [B, k], ids [B, k], partitions_scanned [B]); `stats` as aps_loop."""
    boundary, valid, table = aps_setup(q, centroids, pids, dimension, use_precomputed, table)
    if small_batch:
        def scan_chunk(eff):
            s, si, _ = ivf_scan(q, eff, codes, ids, sizes, k, metric)
            return s, si
    else:
        def scan_chunk(eff):
            s, si, _ = grouped_scan(codes, ids, sizes, norms, q, eff, k, metric, qt, 64,
                                    kernel, exact=exact)
            return s, si
    return aps_loop(q, pids, boundary, valid, table, recall_target, recompute_threshold, k,
                    metric, dimension, chunk, use_precomputed, scan_chunk, gamma=gamma,
                    stats=stats)


def _budgeted_scan(codes, ids, sizes, norms, q, k: int, metric: str, qt: int, kernel: str,
                   exact: bool):
    """The scan closure of the plan-based strategies: scan(eff, pair_budget=0)."""
    def scan(eff, pair_budget=0):
        s, si, _ = grouped_scan(codes, ids, sizes, norms, q, eff, k, metric, qt, 64, kernel,
                                exact=exact, pair_budget=pair_budget)
        return s, si
    return scan


def aps_plan(q, pids, boundary, valid, table, recall_target, k: int, metric: str,
             dimension: int, chunk0: int, use_precomputed: bool, scan_chunk, gamma=None,
             plan_round: int = 4, plan_margin: int = 0, width_clip: int = 0,
             budget_w: int = 0):
    """Planned-APS core (quake_tpu/coordinator.py::aps_plan): scan the top
    `chunk0` ranked partitions, compute the recall profile from the
    resulting k-th radius, plan each query's depth n_b (exclusive
    convention, tail rounded up to plan_round, plus plan_margin where it
    extends past the prologue) and scan ranks [chunk0, n_b) in ONE masked
    scan. `scan_chunk(eff, pair_budget=0)` returns per-query (scores, ids).

    width_clip / budget_w: tails clip to width_clip ranks (plans reach
    chunk0 + width_clip) and to a B * budget_w pair budget, scaled down in
    proportion by a float32 ratio on overflow (floored, as in the JAX
    package); the tail then scans sized to that budget. Nothing here reads
    the device: the budget is a Python int. The plan (radius, profile,
    depths, clip and budget) runs in the span quake.aps.plan. Returns
    (scores, ids, scanned)."""
    B, M = pids.shape
    c0 = min(chunk0, M)
    eff0 = pids[:, :c0]
    s0, i0 = scan_chunk(eff0)
    with annotate("quake.aps.plan"):
        radius = _radius(s0[:, k - 1], q, metric)
        probs = geometry.recall_profile(boundary, radius, dimension, "l2", use_precomputed,
                                        table, valid, gamma=gamma)
        n_b = _plan_depth(probs, recall_target)
        tail = torch.clamp(n_b - c0, min=0)
        if plan_margin:
            tail = torch.where(tail > 0, tail + plan_margin, torch.zeros_like(tail))
        tail = _ceil_to(tail, plan_round)
        n_b = torch.clamp(c0 + tail, c0, M)

        Wt = M
        pair_budget = 0
        if width_clip and budget_w:
            Wt = min(c0 + width_clip, M)
            n_b = torch.clamp(n_b, max=Wt)
            n_bud = B * max(budget_w, plan_round)
            tail = n_b - c0
            total = torch.sum(tail)
            ratio = n_bud / torch.clamp(total.to(torch.float32), min=1.0)
            scaled = torch.floor(tail.to(torch.float32) * ratio).to(tail.dtype)
            tail = torch.where(total > n_bud, scaled, tail)
            n_b = c0 + tail
            pair_budget = int(n_bud)

    rank_idx = torch.arange(Wt, device=pids.device)[None, :]
    n0 = torch.sum((eff0 >= 0).to(torch.int32), dim=1, dtype=torch.int32)
    if Wt <= c0:
        return s0, i0, n0
    tail_mask = (rank_idx[:, c0:] < n_b[:, None])
    eff1 = torch.where(tail_mask, pids[:, c0:Wt], torch.full_like(pids[:, c0:Wt], -1))
    s1, i1 = scan_chunk(eff1, pair_budget)
    scores, sids = merge_topk(s0, i0, s1, i1.to(i0.dtype), k)
    n1 = torch.sum((eff1 >= 0).to(torch.int32), dim=1, dtype=torch.int32)
    return scores, sids, n0 + n1


def aps_search_planned(codes, ids, centroids, q, pids, recall_target, k: int, metric: str,
                       dimension: int, chunk0: int = 4, use_precomputed: bool = True,
                       table=None, qt: int = 32, kernel: str = "xla", sizes=None, norms=None,
                       gamma=None, plan_margin: int = 0, exact: bool = True,
                       width_clip: int = 0, budget_w: int = 0):
    """Two-phase ("planned") APS (quake_tpu/coordinator.py::
    aps_search_planned): prologue scan -> per-query probe plan -> ONE masked
    tail scan (aps_plan). The phase-1 radius upper-bounds the final k-th
    distance, so the plan can only overscan relative to the loop. Returns
    (scores [B, k], ids [B, k], partitions_scanned [B])."""
    boundary, valid, table = aps_setup(q, centroids, pids, dimension, use_precomputed, table)
    scan = _budgeted_scan(codes, ids, sizes, norms, q, k, metric, qt, kernel, exact)
    return aps_plan(q, pids, boundary, valid, table, recall_target, k, metric, dimension,
                    chunk0, use_precomputed, scan, gamma=gamma, plan_margin=plan_margin,
                    width_clip=width_clip, budget_w=budget_w)


def aps_oneshot(q, pids, boundary, valid, table, recall_target, k: int, metric: str,
                dimension: int, use_precomputed: bool, scan_chunk, centroids, radius_a,
                radius_b, gamma=None, plan_round: int = 4, plan_margin: int = 4,
                width_clip: int = 0, budget_w: int = 0):
    """Oneshot-APS core (quake_tpu/coordinator.py::aps_oneshot): the k-th
    radius PREDICTED from the nearest-centroid distance d1 (radius_a +
    radius_b * d1, calibrated at build), the plan from its recall profile
    (margin and rounding on every query), the whole prefix [0, n_b) in ONE
    masked scan. `scan_chunk(eff, pair_budget=0)` returns per-query
    (scores, ids).

    width_clip / budget_w: plans clip to width_clip ranks and to a total of
    B * budget_w pairs (the above-floor tail scaled down in int64 integer
    arithmetic on overflow, never below the plan floor); the scan then runs
    sized to that budget. Nothing here reads the device: the budget is a
    Python int. The plan (radius, profile, depths, clip, budget and the
    masked pid matrix) runs in the span quake.aps.plan. Returns (scores,
    ids, scanned)."""
    B, M = pids.shape
    with annotate("quake.aps.plan"):
        qf = q.to(torch.float32)
        c0 = centroids[torch.clamp(pids[:, 0], min=0).long()].to(torch.float32)
        d1 = torch.sqrt(torch.clamp(torch.sum((qf - c0) ** 2, dim=1), min=0.0))
        radius = torch.clamp(radius_a + radius_b * d1, min=0.0)
        probs = geometry.recall_profile(boundary, radius, dimension, "l2", use_precomputed,
                                        table, valid, gamma=gamma)
        n_b = _plan_depth(probs, recall_target) + plan_margin
        n_b = _ceil_to(n_b, plan_round)
        minf = min(plan_round, M)
        n_b = torch.clamp(n_b, minf, M)

        W = M
        pair_budget = 0
        if width_clip and budget_w:
            W = min(width_clip, M)
            n_b = torch.clamp(n_b, max=W)
            n_bud = B * max(budget_w, int(plan_round))
            total = torch.sum(n_b)
            base = B * minf
            avail = max(n_bud - base, 0)
            denom = torch.clamp(total - base, min=1)
            scaled = minf + torch.div((n_b - minf) * avail, denom, rounding_mode="floor")
            n_b = torch.where(total > n_bud, scaled, n_b)
            pair_budget = int(n_bud)

        rank_idx = torch.arange(W, device=pids.device)[None, :]
        eff = torch.where(rank_idx < n_b[:, None], pids[:, :W],
                          torch.full_like(pids[:, :W], -1))
    scores, sids = scan_chunk(eff, pair_budget)
    return scores, sids, torch.sum((eff >= 0).to(torch.int32), dim=1, dtype=torch.int32)


def aps_search_oneshot(codes, ids, centroids, q, pids, recall_target, k: int, metric: str,
                       dimension: int, radius_a, radius_b, use_precomputed: bool = True,
                       table=None, qt: int = 32, kernel: str = "xla", sizes=None, norms=None,
                       gamma=None, plan_margin: int = 4, exact: bool = True,
                       width_clip: int = 0, budget_w: int = 0):
    """One-pass APS (quake_tpu/coordinator.py::aps_search_oneshot):
    predicted radius -> per-query probe plan -> ONE scan (aps_oneshot).
    Adherence rests on the build-time calibrated predictor. Returns
    (scores [B, k], ids [B, k], partitions_scanned [B])."""
    boundary, valid, table = aps_setup(q, centroids, pids, dimension, use_precomputed, table)
    scan = _budgeted_scan(codes, ids, sizes, norms, q, k, metric, qt, kernel, exact)
    return aps_oneshot(q, pids, boundary, valid, table, recall_target, k, metric, dimension,
                       use_precomputed, scan, centroids, radius_a, radius_b, gamma=gamma,
                       plan_margin=plan_margin, width_clip=width_clip, budget_w=budget_w)


def aps_search_oneshot_fused(codes, ids, centroids, parent_codes, parent_ids, parent_norms, q,
                             recall_target, parent_k: int, mcap: int, k: int, metric: str,
                             dimension: int, radius_a, radius_b, use_precomputed: bool = True,
                             table=None, qt: int = 32, kernel: str = "xla", sizes=None,
                             norms=None, gamma=None, plan_margin: int = 4, exact: bool = True,
                             width_clip: int = 0, budget_w: int = 0,
                             parent_kernel: str = "approx"):
    """Oneshot APS with the parent ranking in the same call
    (quake_tpu/coordinator.py::aps_search_oneshot_fused): rank_parents
    (K3 with parent_kernel="pallas") to parent_k candidates, clipped to mcap
    where that is set (the span quake.plan.parent), then aps_search_oneshot's
    plan and scan. Single-level parents only. Returns (scores, ids,
    scanned, pids)."""
    with annotate("quake.plan.parent"):
        pids = rank_parents(parent_codes, parent_ids, parent_norms, q, parent_k, metric,
                            parent_kernel)
        if mcap and pids.shape[1] > mcap:
            pids = pids[:, :mcap]
    boundary, valid, table = aps_setup(q, centroids, pids, dimension, use_precomputed, table)
    scan = _budgeted_scan(codes, ids, sizes, norms, q, k, metric, qt, kernel, exact)
    scores, sids, scanned = aps_oneshot(q, pids, boundary, valid, table, recall_target, k, metric,
                                        dimension, use_precomputed, scan, centroids, radius_a,
                                        radius_b, gamma=gamma, plan_margin=plan_margin,
                                        width_clip=width_clip, budget_w=budget_w)
    return scores, sids, scanned, pids
