"""The grouped-scan generations chosen by name: v3p, v3pN, v7, v8 and v9
(their counterparts in quake_tpu/ops/pallas_grouped.py).

  v3p, v3pN  kernel K4 (`rowscale_scan(select="topk")`): per-row range key,
             exact per-row top-kk, per-row stats; then `v3p_epilogue`
             (dequantized cross-group merge + exact rescore). K4 also
             serves v6 as it is and, with a chunk table, v4
             (ops/grouped_chunked.py)
  v7         kernel K5 (`rowscale_scan(select="fold")`): the same key,
             fold top-2 (fold 128 unless the caller names another) + kk
             rounds; then `v3p_epilogue`
  v8, v9     kernel K1 (global-scale key, fold top-2, kk rounds); then
             `global_epilogue` (kernel K2 pool merge, the same merge in
             tensor operations with merge="xla", or a top-k; exact rescore)

Groups come from `build_groups`, whose pair-major inverse (pair_group,
pair_slot) lets each (query, probe) pair read its kernel row directly.
The TPU kernels' groups-per-step `gpb` only pads the group count here. K4
and K5 are CUDA kernels (csrc/grouped_rowscale.cu); `rowscale_scan` runs
their plain PyTorch version on CPU tensors and launches them on CUDA
tensors. On whole partitions K4 and K5 multiply on the tensor cores with
split TF32 operands that keep f32 accuracy (ops/split_product.py is the
plain model of that product); K4 with a chunk table in f32 on the CUDA
cores. On bf16 codes the queries are rounded to bf16, as the JAX wrappers
round them, and K4 and K5 run their bf16 bodies (one bf16 product a
depth-16 step on the tensor cores where D % 8 == 0; v4's chunk table on the
CUDA cores, the bf16 values converted to f32 as they load); the epilogue's
|q|^2 and the exact rescore take the unrounded f32 query.
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (build_groups, check_operands, launch_name, operand_bytes,
                                          round_query, use_kernel)
from quake_tpu_torch.ops.grouped_scan import (FOLD, SMEM_LIMIT, check_fold, fold_list_len,
                                              fold_rounds, global_scale, grouped_scan_kernel,
                                              packed_params, pad_groups, pool_tail,
                                              rescore_topk)
from quake_tpu_torch.ops.scan import NEG_INF
from quake_tpu_torch.profiling import annotate

MIN_RANGE = 1e-20  # floor of a row's score range (one valid lane, or none)


def pair_take(arr3, pair_group, pair_slot):
    """arr3[pair_group, pair_slot] -> [B, nprobe, kk] through one flattened
    row take (pallas_grouped.py::_pair_take); pair_group must be >= 0."""
    G, qt, kk = arr3.shape
    return arr3.reshape(G * qt, kk)[(pair_group.long() * qt + pair_slot.long())]


# ------------------------------------------------------------ kernels K4, K5


def topk_cap(kk: int) -> int:
    """Per-row candidate buffer of kernel K4 (csrc/grouped_rowscale.cu)."""
    return -(-kk // 32) * 32 + 128


MMA_BODY, CHUNK_BODY, GROUP_BODY = 2, 1, 0


def rowscale_topk_body(qt: int, D: int, kk: int, chunked: bool = False,
                       dtype=torch.float32) -> int:
    """The body kernel K4's launcher runs at this shape on codes of `dtype`
    (csrc/grouped_rowscale.cu::rowscale_topk_body, asked of the built
    library): MMA_BODY, the tensor-core body, without a chunk table where
    rows are 16-byte aligned for the asynchronous copies (D % 4 == 0 in f32,
    D % 8 == 0 in bf16) and its tiles and candidate buffers fit a block's
    shared memory; CHUNK_BODY, the persistent CUDA-core body, with a chunk
    table where its two segment buffers fit; else GROUP_BODY, the CUDA-core
    body of one block a group."""
    return int(_ext.lib().qk_rowscale_topk_body(qt, D, kk, int(chunked), operand_bytes(dtype)))


def rowscale_fold_body(qt: int, D: int, kk: int, dtype=torch.float32, fold: int = FOLD) -> int:
    """The body kernel K5's launcher runs at this shape and fold width on
    codes of `dtype` (csrc/grouped_rowscale.cu::rowscale_fold_body, asked of
    the built library): MMA_BODY, K4's tensor-core body with the fold
    selection, where rows are 16-byte aligned for the asynchronous copies (D
    % 4 == 0 in f32, D % 8 == 0 in bf16) and its query tile (and at fold =
    128 m, m > 1, kk values a row of fold lists) fits beside a ring stage;
    else GROUP_BODY, the CUDA-core body of one block a group."""
    return int(_ext.lib().qk_rowscale_fold_body(qt, D, kk, operand_bytes(dtype), fold))


def rowscale_scan_plain(gp, group_size, qg, codes, norms, kk: int, slot_mult: int,
                        levels: int, metric: str, select: str = "topk", qsrc=None,
                        row_off=None, ct: int = 0, chunk: int = 256, fold: int = FOLD):
    """Plain PyTorch version of kernels K4 and K5 (same inputs and outputs as
    rowscale_scan), computed `chunk` groups at a time, step by step as
    pallas_grouped.py::_v3p_group_body with _v3p_select (topk) or
    _v7_select (fold). With a chunk table (_v4_kernel), each group scores the
    `ct` rows from row_off[g] of its partition against the query tile
    qsrc[g], and lanes are chunk-local. bf16 operands are upcast and
    multiplied in f32 (a product of two bf16 values is exact there)."""
    Gn = gp.shape[0]
    _, qt, D = qg.shape
    P, C, _ = codes.shape
    dev = qg.device
    chunked = row_off is not None
    W = ct if chunked else C  # lanes per group
    out = torch.full((Gn, qt, kk), -1.0, device=dev, dtype=torch.float32)
    stats = torch.zeros((Gn, qt, 2), device=dev, dtype=torch.float32)
    stats[:, :, 1] = MIN_RANGE
    lane = torch.arange(W, device=dev)
    lane_f = lane.to(torch.float32)
    for g0 in range(0, Gn, chunk):
        sl = slice(g0, min(g0 + chunk, Gn))
        size = group_size[sl].long()
        if chunked:
            size = torch.minimum(size, C - row_off[sl].long())
        alive = torch.nonzero(size > 0).flatten()
        if alive.numel() == 0:
            continue
        p = gp[sl][alive].long()
        if chunked:
            # Rows past the partition's end are clamped; the size masks them.
            rows = torch.clamp((p * C + row_off[sl][alive].long())[:, None] + lane[None, :],
                               max=P * C - 1)
            slab, nrm = codes.reshape(P * C, D)[rows], norms.reshape(P * C)[rows]
            tiles = qg[qsrc[sl][alive].long()]
        else:
            slab, nrm, tiles = codes[p], norms[p], qg[sl][alive]
        prod = torch.bmm(tiles.to(torch.float32),
                         slab.to(torch.float32).transpose(1, 2))  # [a, qt, W]
        scores = 2.0 * prod - nrm[:, None, :] if metric == "l2" else prod
        valid = (lane[None, :] < size[alive][:, None])[:, None, :]
        rowmax = torch.where(valid, scores, torch.full_like(scores, NEG_INF)).amax(2, keepdim=True)
        rowmin = torch.where(valid, scores, torch.full_like(scores, float("inf"))).amin(
            2, keepdim=True)
        rng = torch.clamp(rowmax - rowmin, min=MIN_RANGE)
        qk = torch.floor((scores - rowmin) * (float(levels) / rng))
        packed = torch.where(valid, qk * float(slot_mult) + lane_f,
                             torch.full_like(qk, -1.0))
        a = alive.numel()
        flat = packed.reshape(a * qt, W)
        if select == "fold":
            sel = fold_rounds(flat, kk, fold)
        else:
            sel = torch.topk(flat, kk, dim=1).values
        out[g0 + alive] = sel.reshape(a, qt, kk)
        rm = torch.where(torch.isfinite(rowmin), rowmin, torch.zeros_like(rowmin))
        stats[g0 + alive] = torch.cat([rm, rng], dim=2)
    return out, stats


def rowscale_scan(gp, group_size, qg, codes, norms, kk: int, slot_mult: int, levels: int,
                  metric: str, select: str = "topk", qsrc=None, row_off=None, ct: int = 0,
                  fold: int = FOLD):
    """Kernel K4 (select="topk"; replaces pallas_grouped.py::_v3p_kernel,
    _v3pn_kernel, _v6_kernel and, with a chunk table, _v4_kernel) or K5
    (select="fold"; replaces _v7_kernel).

    gp [Gn] int32 partition per group; group_size [Gn] int32 (<= 0: ghost);
    qg [Gn, qt, D] unscaled queries and codes [P, C, D], both f32 or both
    bf16 (launches of the bf16 bodies count under "rowscale_topk_bf16" and
    "rowscale_fold_bf16"); norms [P, C] f32 squared norms. Per row: scores
    over the valid lanes (lane < size),
    the row's range, packed = floor((s - rowmin) * (levels / rng)) *
    slot_mult + lane. Returns (out [Gn, qt, kk] f32 packed, descending, -1 =
    none; stats [Gn, qt, 2] f32 = (rowmin or 0, rng)). Ghost groups write -1
    and stats (0, 1e-20). K4 takes any C; K5 folds by `fold` (32, 64 or a
    multiple of 128, see grouped_scan.fold_served), which must divide C.

    The chunk table (K4 only, the v4 scan): qsrc [Gn] int32 names the query
    tile of qg [G, qt, D] each group reads, row_off [Gn] int32 the first of
    the `ct` rows of its partition it scores; group_size then counts the
    chunk's valid lanes, and lanes and slots are chunk-local.

    K4's launcher picks one of three bodies by shape (`rowscale_topk_body`),
    K5's one of two (`rowscale_fold_body`), never after a failure; all
    compute the same function. Whole partitions take the tensor-core body
    (split TF32 product, asynchronous copies, a persistent block per SM)
    where D % 4 == 0 (a row is 16-byte aligned) and its query tile and
    candidate buffers fit shared memory. A chunk table takes a persistent
    CUDA-core body (f32): a chunk's row range can be far below its scores,
    its keys then resolve the scores' last places, and only f32 sums in the
    order of D reproduce the plain version's there. Every other shape takes
    the CUDA-core body of one block a group."""
    Gn = gp.shape[0]
    G, qt, D = qg.shape
    P, C, _ = codes.shape
    chunked = qsrc is not None or row_off is not None
    if select not in ("topk", "fold"):
        raise ValueError(f"rowscale_scan: select must be 'topk' or 'fold', got {select!r}")
    if select == "fold":
        check_fold("rowscale fold selection", fold, C)
    if chunked and (select != "topk" or qsrc is None or row_off is None or ct <= 0):
        raise ValueError("rowscale_scan: a chunk table needs select='topk', qsrc, row_off "
                         "and ct > 0")
    if not chunked and G != Gn:
        raise ValueError(f"rowscale_scan: qg must hold one tile per group ({G} != {Gn})")
    if not use_kernel("rowscale_scan", qg):
        return rowscale_scan_plain(gp, group_size, qg, codes, norms, kk, slot_mult,
                                   levels, metric, select, qsrc, row_off, ct, fold=fold)
    dtype = codes.dtype
    name = launch_name("rowscale_topk" if select == "topk" else "rowscale_fold", dtype)
    Dp = -(-D // 4) * 4
    cap = topk_cap(kk) if select == "topk" else fold_list_len(fold, kk)
    body = (rowscale_topk_body(qt, D, kk, chunked, dtype) if select == "topk"
            else rowscale_fold_body(qt, D, kk, dtype, fold))
    if body == GROUP_BODY and (qt * Dp + FOLD * (Dp + 1) + qt * cap) * 4 > SMEM_LIMIT:
        raise ValueError(f"rowscale_scan: D={D}, qt={qt}, kk={kk} need more shared memory "
                         "than a block has (kernel K4 keeps round_up(kk, 32) + 128 "
                         "candidates per row, K5 at a fold of 128 m, m > 1, kk)")
    check_operands("rowscale_scan", qg.device, (
        ("gp", gp, torch.int32, (Gn,)),
        ("group_size", group_size, torch.int32, (Gn,)),
        ("qg", qg, dtype, (G, qt, D)),
        ("codes", codes, dtype, (P, C, D)),
        ("norms", norms, torch.float32, (P, C))) + (
        (("qsrc", qsrc, torch.int32, (Gn,)), ("row_off", row_off, torch.int32, (Gn,)))
        if chunked else ()), qt, body == MMA_BODY)
    out = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    stats = torch.empty((Gn, qt, 2), device=qg.device, dtype=torch.float32)
    args = (qg, codes, norms, out, stats, Gn, qt, D, P, C, kk, int(metric == "l2"),
            float(slot_mult), float(levels))
    if select == "topk":
        _ext.launch(name, gp, group_size, qsrc, row_off, *args, outputs=(out, stats))
    else:
        _ext.launch(name, gp, group_size, *args, int(fold), outputs=(out, stats))
    return out, stats


# ---------------------------------------------------------------- epilogues


def v3p_epilogue(g_packed, g_stats, group_pid, pair_group, pair_slot, pids, safe_q,
                 codes, ids, norms, q, k: int, kk: int, metric: str, slot_mult: int,
                 levels: int, dedup: bool = False):
    """Shared v3p/v3pN/v7 epilogue (pallas_grouped.py::_v3p_epilogue):
    decode the packed winners, dequantize with the per-row stats
    (rowmin + key * rng / levels, minus |q|^2 for l2), merge per query by
    that score and exact-rescore the top k. The TPU epilogue's `alive` mask
    for ghost groups is not needed: K4 and K5 write them as -1."""
    B = q.shape[0]
    with annotate("quake.plan.merge"):
        valid = g_packed >= 0.0
        slots = torch.remainder(g_packed, float(slot_mult)).to(torch.int32)
        keys = torch.floor(g_packed / float(slot_mult))
        approx = g_stats[:, :, 0:1] + keys * (g_stats[:, :, 1:2] / float(levels))
        if metric == "l2":
            qf = q.to(torch.float32)
            approx = approx - torch.sum(qf * qf, dim=1)[safe_q][:, :, None]
        approx = torch.where(valid, approx, torch.full_like(approx, NEG_INF))
        gpid = torch.clamp(group_pid, min=0).to(torch.int32)[:, None, None]
        refs = torch.where(valid, (gpid << 16) | slots, torch.full_like(slots, -1))

        ok = (pair_group >= 0)[:, :, None]
        pg = torch.clamp(pair_group, min=0)
        m_scores = torch.where(ok, pair_take(approx, pg, pair_slot), NEG_INF).reshape(B, -1)
        m_refs = torch.where(ok, pair_take(refs, pg, pair_slot), -1).reshape(B, -1)
    with annotate("quake.plan.rescore"):
        return rescore_topk(m_scores, m_refs, codes, ids, norms, q, k, kk, metric, pids,
                            dedup=dedup)


def global_epilogue(g_packed, pair_group, pair_slot, pids, codes, ids, norms,
                    q, k: int, kk: int, metric: str, slot_mult: int, levels: int,
                    dedup: bool = False, merge: str = "pallas"):
    """Shared v8/v9 epilogue (pallas_grouped.py::_global_epilogue, exact).
    The global-scale keys compare across groups, so each query's probe-order
    pool of kernel rows is merged in key domain by kernel K2 (merge
    "pallas"), by the same fold-128 merge in tensor operations (merge "xla",
    the JAX function's default; no K2), or by a top-k where the packing does
    not fit (kk < k, or levels*lane_mult + lane_mult >= 2^24) or dedup asks
    for it (a spilled store: rescore_topk's dedup). Ghost groups need no
    mask: K1 writes them as -1. Landing each query's kernel rows in its pool
    is this scan's placement (quake.plan.placement)."""
    B = q.shape[0]
    with annotate("quake.plan.placement"):
        ok = (pair_group >= 0)[:, :, None]
        m_packed = torch.where(ok, pair_take(g_packed, torch.clamp(pair_group, min=0),
                                             pair_slot), -1.0).reshape(B, -1)
    return pool_tail(m_packed, pids, pids, codes, ids, norms, q, k, kk, metric, slot_mult,
                     levels, general=kk < k, dedup=dedup, merge=merge)


# ----------------------------------------------------------------- wrappers


def check_refs(name: str, P: int, C: int) -> None:
    if P >= 32768 or C > 65536:
        raise ValueError(f"{name} packs (pid, slot) into int32: needs P < 32768, C <= 65536")


def rowscale_search(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int,
                     gpb: int, select: str, dedup: bool = False, fold: int = FOLD):
    """Grouping, kernel K4 or K5, and the v3p epilogue, with its dedup on a
    spilled store. The query tiles are rounded to the codes' dtype
    (pallas_grouped.py:385, 718, 879); the epilogue takes q unrounded."""
    P, C, _ = codes.shape
    kk = min(k, C)
    slot_mult, levels = packed_params(C)
    with annotate("quake.plan.grouping"):
        group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
        gp, _, group_size, safe_q = pad_groups(group_pid, qlist, sizes, gpb)
        qg = round_query(q, codes.dtype)[safe_q].contiguous()  # [Gn, qt, D]
    with annotate("quake.scan"):
        g_packed, g_stats = rowscale_scan(gp, group_size, qg, codes, norms, kk, slot_mult,
                                          levels, metric, select, fold=fold)
    return v3p_epilogue(g_packed, g_stats, gp, pair_group, pair_slot, pids, safe_q, codes,
                        ids, norms, q, k, kk, metric, slot_mult, levels, dedup=dedup)


def grouped_scan_v3p(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32):
    """v3p grouped scan (pallas_grouped.py::grouped_scan_pallas_v3p): one
    group per TPU grid step, kernel K4, exact rescore of the winners.

    codes [P, C, D] f32 or bf16, ids [P, C] int32, sizes [P] int32, norms
    [P, C] f32, q [B, D], pids [B, nprobe] int32 (-1 = pad). Returns (scores
    [B, k] f32, ids [B, k] int32, scanned [B] int32). Any C."""
    P, C, _ = codes.shape
    check_refs("v3p", P, C)
    return rowscale_search(codes, ids, sizes, norms, q, pids, k, metric, qt, 1, "topk")


def grouped_scan_v3pn(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                      gpb: int = 2, dedup: bool = False):
    """v3pN grouped scan (pallas_grouped.py::grouped_scan_pallas_v3pn): v3p
    with the groups padded to a multiple of gpb (the TPU kernel's groups per
    grid step); the dispatch's fallback for C % fold != 0. Same inputs and
    returns as grouped_scan_v3p; dedup: the v3p epilogue's (a spilled
    store)."""
    P, C, _ = codes.shape
    check_refs("v3p", P, C)
    return rowscale_search(codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, "topk",
                            dedup)


def grouped_scan_v7(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                    gpb: int = 4, fold: int = FOLD, dedup: bool = False):
    """v7 grouped scan (pallas_grouped.py::grouped_scan_pallas_v7): the
    per-row key of v3p with the fold selection (fold 128 by default), kernel
    K5. Approximate at the fold-column level (at most two winners per
    column); winners are exact-rescored. Needs C % fold == 0 and a served
    fold (grouped_scan.check_fold). Same inputs and returns as
    grouped_scan_v3pn."""
    P, C, _ = codes.shape
    check_refs("v7", P, C)
    check_fold("v7", fold, C)
    return rowscale_search(codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, "fold",
                            dedup, fold)


def grouped_scan_v8(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                    gpb: int = 4, fold: int = FOLD, dedup: bool = False,
                    bounds: str = "analytic", merge: str = "pallas"):
    """v8 global-scale grouped scan (pallas_grouped.py::grouped_scan_pallas_v8)
    on kernel K1, which computes _v8_kernel's function (its ghost groups
    write -1 where the TPU kernel leaves stale rows for the epilogue's mask),
    then the K2 pool merge, or with merge="xla" the same merge in tensor
    operations (a top-k with dedup, see global_epilogue). Needs C % fold ==
    0 and a served fold (grouped_scan.check_fold). Same inputs and returns
    as grouped_scan_v3pn; bounds "analytic" or "sampled", the key's scale
    (grouped_scan.global_bounds).
    """
    P, C, _ = codes.shape
    check_refs("v8", P, C)
    check_fold("v8", fold, C)
    kk = min(k, C)
    slot_mult, levels = packed_params(C)
    with annotate("quake.plan.grouping"):
        q_scaled, normsT, _, _ = global_scale(q, norms, metric, levels, bounds, codes, sizes)
        group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
        gp, _, group_size, safe_q = pad_groups(group_pid, qlist, sizes, gpb)
        qg = q_scaled.to(codes.dtype)[safe_q].contiguous()  # [Gn, qt, D], rounded as the codes
    with annotate("quake.scan"):
        g_packed = grouped_scan_kernel(gp, group_size, qg, codes, normsT, kk, slot_mult,
                                       levels, fold)
    return global_epilogue(g_packed, pair_group, pair_slot, pids, codes, ids, norms, q, k,
                           kk, metric, slot_mult, levels, dedup, merge)


# v9 (pallas_grouped.py::grouped_scan_pallas_v9) is v8 with joint selection
# rounds over gpb groups, which change nothing per row (_v9_kernel's
# docstring): the same function on kernel K1.
grouped_scan_v9 = grouped_scan_v8
