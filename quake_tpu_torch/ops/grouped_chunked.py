"""The size-aware chunked grouped scans chosen by name: v4, v5 and v6 (their
counterparts are quake_tpu/ops/pallas_grouped.py::grouped_scan_pallas_v4,
_v5 and _v6). All three cut a partition's C rows into chunks of `ct` rows
and touch only the chunks below the partition's size; all key each row on
its own score range, as v3p does, and exact-rescore the winners.

  v4  one kernel group per (partition, query tile, chunk), from
      `build_chunk_groups`: kernel K4 with a chunk table (chunk-local slots,
      slot_mult = next_pow2(ct)); the epilogue dequantizes and merges in two
      stages, per (query, probe) over the chunks, then across the probes
  v5  one kernel group per (partition, query tile): kernel K7
      (`chunk_merge`) runs the v3p body on each chunk, dequantizes its kk
      winners and merges them across the chunks by (score, larger slot); the
      epilogue is one merge across the probes. K7 multiplies on the tensor
      cores with split TF32 operands where D % 4 == 0 (one product a chunk
      of one 128-row segment), else in f32 on the CUDA cores
  v6  kernel K4 as it is: _v6_kernel fetches in chunks and then runs one
      _v3p_select over the whole row with slot_mult = next_pow2(C), the
      function of _v3pn_kernel; K4 already reads only the 128-row segments
      below the size

The TPU kernels' groups-per-step `gpb` only pads the group count here. K7
is a CUDA kernel
(csrc/grouped_rowscale.cu); `chunk_merge` runs its plain PyTorch version on
CPU tensors and launches it on CUDA tensors. On bf16 codes all three round
the query tiles to bf16, as the JAX wrappers do, and run the bf16 bodies of
K4 and K7; their epilogues subtract |q|^2 of the unrounded query and the
rescore takes it unrounded, as in the JAX package.
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (build_chunk_groups, build_groups, check_operands,
                                          launch_name, operand_bytes, round_query, use_kernel)
from quake_tpu_torch.ops.grouped_family import (MIN_RANGE, check_refs, pair_take, rowscale_scan,
                                                rowscale_search, topk_cap)
from quake_tpu_torch.ops.grouped_scan import (FOLD, SMEM_LIMIT, packed_params, pad_groups,
                                              rescore_topk)
from quake_tpu_torch.ops.scan import NEG_INF, topk_stable
from quake_tpu_torch.profiling import annotate


def _check_chunked(name: str, P: int, C: int, ct: int) -> None:
    check_refs(name, P, C)
    if ct <= 0 or C % ct:
        raise ValueError(f"{name} needs C % ct == 0 (C={C}, ct={ct})")


def _dequantize(packed, stats, slot_mult: int, levels: int):
    """Packed winners and their rows' stats -> (rowmin + key * (rng / levels),
    slot int32). Only entries with packed >= 0 mean anything."""
    keys = torch.floor(packed / float(slot_mult))
    slots = torch.remainder(packed, float(slot_mult)).to(torch.int32)
    return stats[..., 0:1] + keys * (stats[..., 1:2] / float(levels)), slots


# ---------------------------------------------------------------- kernel K7


def chunk_merge_plain(gp, group_size, qg, codes, norms, kk: int, ct: int, slot_mult: int,
                      levels: int, metric: str, chunk: int = 128):
    """Plain PyTorch version of kernel K7 (same inputs and outputs as
    chunk_merge), `chunk` groups at a time, as pallas_grouped.py::_v5_kernel:
    _v3p_group_body per [qt, ct] chunk, the dequantized candidates of all
    chunks side by side, then the kk best by (score, larger slot). bf16
    operands are upcast and multiplied in f32."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    maxch = C // ct
    dev = qg.device
    out_s = torch.full((Gn, qt, kk), NEG_INF, device=dev, dtype=torch.float32)
    out_i = torch.full((Gn, qt, kk), -1, device=dev, dtype=torch.int32)
    lane = torch.arange(ct, device=dev)
    first = (torch.arange(maxch, device=dev) * ct)  # first row of each chunk
    for g0 in range(0, Gn, chunk):
        sl = slice(g0, min(g0 + chunk, Gn))
        size = torch.where(gp[sl] >= 0, group_size[sl], torch.zeros_like(group_size[sl])).long()
        alive = torch.nonzero(size > 0).flatten()
        if alive.numel() == 0:
            continue
        a = alive.numel()
        p = gp[sl][alive].long()
        prod = torch.bmm(qg[sl][alive].to(torch.float32),
                         codes[p].to(torch.float32).transpose(1, 2))  # [a, qt, C]
        scores = 2.0 * prod - norms[p][:, None, :] if metric == "l2" else prod
        scores = scores.reshape(a, qt, maxch, ct)
        csize = torch.clamp(size[alive][:, None] - first[None, :], 0, ct)  # [a, maxch]
        valid = (lane[None, None, :] < csize[:, :, None])[:, None, :, :]
        rowmax = torch.where(valid, scores, torch.full_like(scores, NEG_INF)).amax(3, keepdim=True)
        rowmin = torch.where(valid, scores, torch.full_like(scores, float("inf"))).amin(
            3, keepdim=True)
        rng = torch.clamp(rowmax - rowmin, min=MIN_RANGE)
        qk = torch.floor((scores - rowmin) * (float(levels) / rng))
        packed = torch.where(valid, qk * float(slot_mult) + lane.to(torch.float32),
                             torch.full_like(qk, -1.0))
        sel = torch.topk(packed, kk, dim=3).values  # [a, qt, maxch, kk]
        rm = torch.where(torch.isfinite(rowmin), rowmin, torch.zeros_like(rowmin))
        cand_s, slot_loc = _dequantize(sel, torch.cat([rm, rng], dim=3), slot_mult, levels)
        cand_s = torch.where(sel >= 0.0, cand_s, torch.full_like(cand_s, NEG_INF))
        cand_i = torch.where(sel >= 0.0, first.to(torch.int32)[None, None, :, None] + slot_loc,
                             torch.full_like(slot_loc, -1))
        cand_s, cand_i = cand_s.reshape(a, qt, maxch * kk), cand_i.reshape(a, qt, maxch * kk)
        # Score descending, then the larger slot: a stable sort by score of
        # the candidates in descending-slot order. Slots are distinct, so
        # this is the TPU kernel's kk rounds of max-and-clear.
        by_slot = torch.argsort(cand_i, dim=2, descending=True, stable=True)
        top_s, order = topk_stable(torch.gather(cand_s, 2, by_slot), kk)
        out_s[g0 + alive] = top_s
        out_i[g0 + alive] = torch.gather(torch.gather(cand_i, 2, by_slot), 2, order)
    return out_s, out_i


MMA_BODY, GROUP_BODY = 1, 0  # chunk_merge_body's answers


def chunk_merge_body(qt: int, D: int, kk: int, dtype=torch.float32) -> int:
    """The body kernel K7's launcher runs at this shape on codes of `dtype`
    (csrc/grouped_rowscale.cu::chunk_merge_body, asked of the built library):
    MMA_BODY, the tensor-core body, where rows are 16-byte aligned for the
    asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and its ring,
    query tile, candidate buffers and merge lists fit a block's shared memory
    (the bf16 query tile takes half the room); else GROUP_BODY, the
    CUDA-core body of one block a group."""
    return int(_ext.lib().qk_chunk_merge_body(qt, D, kk, operand_bytes(dtype)))


def chunk_merge(gp, group_size, qg, codes, norms, kk: int, ct: int, slot_mult: int, levels: int,
                metric: str):
    """Kernel K7 (replaces pallas_grouped.py::_v5_kernel).

    gp [Gn] int32 partition per group (-1: ghost); group_size [Gn] int32
    (<= 0: ghost); qg [Gn, qt, D] unscaled queries and codes [P, C, D],
    C % ct == 0, both f32 or both bf16 (launches of the bf16 body count under
    "chunk_merge_bf16"); norms [P, C] f32. Per group and chunk c < ceil(size / ct):
    K4's per-row-range packed top-kk over the chunk's valid lanes, with
    slot_mult = next_pow2(ct), dequantized to rowmin + key * (rng / levels)
    at slot c * ct + lane; then per row the kk best over all chunks, score
    descending and the larger slot first among equal scores. Returns (scores
    [Gn, qt, kk] f32, without the per-query |q|^2, -inf = none; slots
    [Gn, qt, kk] int32, -1 = none).

    The launcher picks one of two bodies by shape (`chunk_merge_body`),
    never after a failure: the tensor-core body (split TF32 product, one
    product a chunk of one segment, asynchronous copies, a persistent block
    per SM) or the CUDA-core body of one block a group (f32), which serves
    D % 4 != 0 and the shapes whose merge lists crowd out the ring."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if ct <= 0 or C % ct:
        raise ValueError(f"chunk_merge needs C % ct == 0 (C={C}, ct={ct})")
    if kk > ct:
        raise ValueError(f"chunk_merge needs kk <= ct (kk={kk}, ct={ct})")
    if not use_kernel("chunk_merge", qg):
        return chunk_merge_plain(gp, group_size, qg, codes, norms, kk, ct, slot_mult, levels,
                                 metric)
    dtype = codes.dtype
    Dp = -(-D // 4) * 4
    body = chunk_merge_body(qt, D, kk, dtype)
    if (body == GROUP_BODY
            and (qt * Dp + FOLD * (Dp + 1) + qt * topk_cap(kk) + qt * 6 * kk) * 4 > SMEM_LIMIT):
        raise ValueError(f"chunk_merge: D={D}, qt={qt}, kk={kk} need more shared memory than "
                         "a block has (kernel K7 keeps round_up(kk, 32) + 128 candidates and "
                         "three lists of kk (score, slot) pairs per row)")
    check_operands("chunk_merge", qg.device, (
        ("gp", gp, torch.int32, (Gn,)),
        ("group_size", group_size, torch.int32, (Gn,)),
        ("qg", qg, dtype, (Gn, qt, D)),
        ("codes", codes, dtype, (P, C, D)),
        ("norms", norms, torch.float32, (P, C))), qt, body == MMA_BODY)
    out_s = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    out_i = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.int32)
    _ext.launch(launch_name("chunk_merge", dtype), gp, group_size, qg, codes, norms, out_s, out_i,
                Gn, qt, D, P, C, ct, kk, int(metric == "l2"), float(slot_mult), float(levels),
                outputs=(out_s,))
    return out_s, out_i


# ----------------------------------------------------------------- wrappers


def grouped_scan_v6(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                    ct: int = 512, gpb: int = 4, dedup: bool = False):
    """v6 grouped scan (pallas_grouped.py::grouped_scan_pallas_v6): chunked
    fetch, one selection over the whole row. On kernel K4 unchanged, which
    computes _v6_kernel's function (that of _v3pn_kernel) and reads only the
    segments below the partition's size; `ct` only has to divide C. Same
    inputs and returns as grouped_scan_v3pn (dedup: the v3p epilogue's)."""
    P, C, _ = codes.shape
    _check_chunked("v6", P, C, ct)
    return rowscale_search(codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, "topk",
                           dedup)


def grouped_scan_v5(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                    ct: int = 512, gpb: int = 4, dedup: bool = False):
    """v5 grouped scan (pallas_grouped.py::grouped_scan_pallas_v5): per-chunk
    selection and the cross-chunk merge in kernel K7, then one merge across
    the probes and the exact rescore (rescore_topk, with its dedup on a
    spilled store). Needs C % ct == 0. Same inputs and returns as
    grouped_scan_v3pn."""
    B = q.shape[0]
    P, C, _ = codes.shape
    _check_chunked("v5", P, C, ct)
    kk = min(k, ct)
    slot_mult, levels = packed_params(ct)
    with annotate("quake.plan.grouping"):
        group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
        gp, _, group_size, safe_q = pad_groups(group_pid, qlist, sizes, gpb)
        qf = q.to(torch.float32)
        qg = round_query(q, codes.dtype)[safe_q].contiguous()  # [Gn, qt, D]
    with annotate("quake.scan"):
        g_scores, g_slots = chunk_merge(gp, group_size, qg, codes, norms, kk, ct, slot_mult,
                                        levels, metric)
    # Slim epilogue: the per-query -|q|^2 back (of the unrounded query, as
    # pallas_grouped.py:2307-2313), refs, one merge. The TPU
    # epilogue's `alive` mask is not needed: K7 writes ghost groups as -1.
    with annotate("quake.plan.merge"):
        valid = g_slots >= 0
        if metric == "l2":
            g_scores = g_scores - torch.sum(qf * qf, dim=1)[safe_q][:, :, None]
        g_scores = torch.where(valid, g_scores, torch.full_like(g_scores, NEG_INF))
        gpid = torch.clamp(gp, min=0)[:, None, None]
        refs = torch.where(valid, (gpid << 16) | g_slots, torch.full_like(g_slots, -1))
        ok = (pair_group >= 0)[:, :, None]
        pg = torch.clamp(pair_group, min=0)
        m_scores = torch.where(ok, pair_take(g_scores, pg, pair_slot), NEG_INF).reshape(B, -1)
        m_refs = torch.where(ok, pair_take(refs, pg, pair_slot), -1).reshape(B, -1)
    with annotate("quake.plan.rescore"):
        return rescore_topk(m_scores, m_refs, codes, ids, norms, q, k, kk, metric, pids,
                            dedup=dedup)


def grouped_scan_v4(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32,
                    ct: int = 512, gpb: int = 8, mat_qg: bool = False, dedup: bool = False):
    """v4 grouped scan (pallas_grouped.py::grouped_scan_pallas_v4): one
    kernel group per chunk that holds vectors, kernel K4 with a chunk table,
    a two-stage dequantized merge and the exact rescore. Needs C % ct == 0.
    mat_qg gathers one query tile per chunk-group instead of letting the
    kernel follow cg_qsrc; the result is the same. Same inputs and returns
    as grouped_scan_v3pn (dedup: rescore_topk's, a spilled store)."""
    B, nprobe = pids.shape
    P, C, _ = codes.shape
    _check_chunked("v4", P, C, ct)
    kk = min(k, ct)
    slot_mult, levels = packed_params(ct)
    with annotate("quake.plan.grouping"):
        cg_pid, cg_chunk, cg_qsrc, cg_size, qlist, pair_cg, pair_slot = build_chunk_groups(
            pids, sizes, P, qt, ct, C)
        pad = -(-cg_pid.shape[0] // gpb) * gpb - cg_pid.shape[0]
        cg_pid = torch.nn.functional.pad(cg_pid, (0, pad), value=-1)
        cg_chunk, cg_qsrc, cg_size = (torch.nn.functional.pad(t, (0, pad))
                                      for t in (cg_chunk, cg_qsrc, cg_size))
        safe_q = torch.clamp(qlist, min=0).long()  # [G, qt]
        qf = q.to(torch.float32)
        qg = round_query(q, codes.dtype)[safe_q].contiguous()  # [G, qt, D]
        row_off = (cg_chunk * ct).contiguous()
        if mat_qg:
            qg = qg[cg_qsrc.long()].contiguous()  # [Gn, qt, D]
            qsrc = torch.arange(cg_pid.shape[0], device=qg.device, dtype=torch.int32)
        else:
            qsrc = cg_qsrc
    with annotate("quake.scan"):
        g_packed, g_stats = rowscale_scan(cg_pid, cg_size, qg, codes, norms, kk, slot_mult,
                                          levels, metric, "topk", qsrc=qsrc, row_off=row_off,
                                          ct=ct)
    # Decode and dequantize. The TPU epilogue's `alive` mask is not needed:
    # K4 writes ghost chunk-groups as -1.
    with annotate("quake.plan.merge"):
        valid = g_packed >= 0.0
        approx, slots_local = _dequantize(g_packed, g_stats, slot_mult, levels)
        if metric == "l2":
            approx = approx - torch.sum(qf * qf, dim=1)[safe_q][cg_qsrc.long()][:, :, None]
        approx = torch.where(valid, approx, torch.full_like(approx, NEG_INF))
        gpid = torch.clamp(cg_pid, min=0)[:, None, None]
        refs = torch.where(valid, (gpid << 16) | (row_off[:, None, None] + slots_local),
                           torch.full_like(slots_local, -1))
        # Stage 1: each (query, probe) pair reduces its chunks' kk candidates to kk.
        maxch = pair_cg.shape[2]
        okc = (pair_cg >= 0).reshape(B, nprobe * maxch, 1)
        pcg = torch.clamp(pair_cg, min=0).reshape(B, nprobe * maxch)
        ps = pair_slot[:, :, None].expand(B, nprobe, maxch).reshape(B, nprobe * maxch)
        s = torch.where(okc, pair_take(approx, pcg, ps), NEG_INF).reshape(B, nprobe, maxch * kk)
        rf = torch.where(okc, pair_take(refs, pcg, ps), -1).reshape(B, nprobe, maxch * kk)
        if maxch > 1:
            s, idx = topk_stable(s, kk)
            rf = torch.gather(rf, 2, idx)
    # Stage 2: the merge across the probes and the exact rescore.
    with annotate("quake.plan.rescore"):
        return rescore_topk(s.reshape(B, -1), rf.reshape(B, -1), codes, ids, norms, q, k, kk,
                            metric, pids, dedup=dedup)
