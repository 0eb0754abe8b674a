"""The exact-score grouped scans chosen by name: v3 and v2 (their
counterparts are quake_tpu/ops/pallas_grouped.py::grouped_scan_pallas_v3 and
grouped_scan_pallas).

Both select on the f32 scores themselves, with no quantized key, and end in
`merge_groups`:

  v3  kernel K6 in mode "slot": scores from the cached norms, lanes below the
      partition's size, kk rounds of (max score, max slot among ties); the
      epilogue adds the per-query -|q|^2 back and maps slot -> id
  v2  kernel K6 in mode "id": |q|^2 and |x|^2 summed in the kernel, lanes
      with id >= 0 (no sizes, so the whole slab is read), kk rounds of (max
      score, max id among ties); the kernel emits ids

K6 is a CUDA kernel (csrc/grouped_exact.cu); `exact_scan` runs its plain
PyTorch version on CPU tensors and launches it on CUDA tensors. Where
D % 4 == 0 and its lists fit, it multiplies on the tensor cores with split
TF32 operands that keep f32 accuracy (ops/split_product.py is the plain
model of that product). On bf16 codes the queries are rounded to bf16, as
the JAX wrappers round them, and K6 runs its bf16 body (one bf16 product a
depth-16 step on the tensor cores where D % 8 == 0, exact in f32); v2's
|q|^2 comes from the rounded tile in the kernel, v3's epilogue subtracts
|q|^2 of the unrounded query, as in the JAX package.
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (build_groups, check_operands, launch_name, merge_groups,
                                          operand_bytes, round_query, use_kernel)
from quake_tpu_torch.ops.grouped_family import topk_cap
from quake_tpu_torch.ops.grouped_scan import FOLD, SMEM_LIMIT
from quake_tpu_torch.ops.scan import NEG_INF
from quake_tpu_torch.profiling import annotate

MODES = ("slot", "id")
MMA_BODY, GROUP_BODY = 1, 0  # exact_topk_body's answers


def exact_topk_body(qt: int, D: int, kk: int, dtype=torch.float32) -> int:
    """The body kernel K6's launcher runs at this shape, in either mode, on
    codes of `dtype` (csrc/grouped_exact.cu::qk_exact_topk_body, asked of the
    built library): MMA_BODY, multi_topk's tensor-core body
    (csrc/pair_topk_mma.cuh), where rows are 16-byte aligned for the
    asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and its ring,
    query tile and per-row lists fit a block's shared memory; else
    GROUP_BODY, the CUDA-core body of one block a group."""
    return int(_ext.lib().qk_exact_topk_body(qt, D, kk, operand_bytes(dtype)))


def exact_topk_serves(qt: int, D: int, kk: int, dtype=torch.float32) -> bool:
    """Whether K6 serves (qt, D, kk) on the card: its tensor-core body takes
    the shape, or its CUDA-core body's round_up(kk, 32) + 128 (score, index)
    pairs per row fit a block's shared memory beside the query tile and a
    segment (f32 there whatever the codes' dtype)."""
    Dp = -(-D // 4) * 4
    return (exact_topk_body(qt, D, kk, dtype) == MMA_BODY
            or (qt * Dp + FOLD * (Dp + 1) + FOLD + qt * 2 * topk_cap(kk)) * 4 <= SMEM_LIMIT)


def exact_scan_plain(gp, qg, codes, kk: int, metric: str, mode: str, group_size=None,
                     norms=None, ids=None, chunk: int = 256):
    """Plain PyTorch version of kernel K6 (same inputs and outputs as
    exact_scan), `chunk` groups at a time, round by round as
    pallas_grouped.py::_v3_kernel (mode "slot") and _grouped_kernel (mode
    "id"). bf16 operands are upcast and multiplied in f32 (a product of two
    bf16 values is exact there)."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    dev = qg.device
    out_s = torch.full((Gn, qt, kk), NEG_INF, device=dev, dtype=torch.float32)
    out_i = torch.full((Gn, qt, kk), -1, device=dev, dtype=torch.int32)
    lane = torch.arange(C, device=dev, dtype=torch.int32)
    for g0 in range(0, Gn, chunk):
        sl = slice(g0, min(g0 + chunk, Gn))
        live = gp[sl] >= 0 if mode == "id" else group_size[sl] > 0
        alive = torch.nonzero(live).flatten()
        if alive.numel() == 0:
            continue
        p = gp[sl][alive].long()
        qa = qg[sl][alive].to(torch.float32)
        slab = codes[p].to(torch.float32)
        prod = torch.bmm(qa, slab.transpose(1, 2))  # [a, qt, C]
        if mode == "id":
            tag = ids[p][:, None, :].expand(-1, qt, -1)
            valid = tag >= 0
            if metric == "l2":
                q_sq = torch.sum(qa * qa, dim=2, keepdim=True)
                s_sq = torch.sum(slab * slab, dim=2)
                scores = 2.0 * prod - q_sq - s_sq[:, None, :]
            else:
                scores = prod
        else:
            tag = lane[None, None, :].expand(alive.numel(), qt, -1)
            valid = tag < group_size[sl][alive][:, None, None]
            scores = 2.0 * prod - norms[p][:, None, :] if metric == "l2" else prod
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        for i in range(kk):
            best = scores.amax(dim=2, keepdim=True)
            is_best = scores == best
            best_tag = torch.where(is_best, tag, torch.full_like(tag, -1)).amax(dim=2,
                                                                             keepdim=True)
            out_s[g0 + alive, :, i] = best[:, :, 0]
            out_i[g0 + alive, :, i] = torch.where(best == NEG_INF, torch.full_like(best_tag, -1),
                                                  best_tag)[:, :, 0]
            scores = torch.where(is_best & (tag == best_tag), torch.full_like(scores, NEG_INF),
                                 scores)
    return out_s, out_i


def exact_scan(gp, qg, codes, kk: int, metric: str, mode: str, group_size=None, norms=None,
               ids=None):
    """Kernel K6 (replaces pallas_grouped.py::_v3_kernel in mode "slot" and
    _grouped_kernel in mode "id").

    gp [Gn] int32 partition per group (-1: ghost); qg [Gn, qt, D] queries
    and codes [P, C, D], both f32 or both bf16 (launches of the bf16 body
    count under "exact_topk_bf16"). Mode "slot" takes group_size [Gn] int32
    (<= 0: ghost) and norms [P, C] f32: scores 2<q, x> - |x|^2 (l2, without
    the per-query |q|^2) or <q, x> (ip) over the lanes below the size, ties
    to the larger slot. Mode "id" takes ids [P, C] int32: scores
    2<q, x> - |q|^2 - |x|^2 with both norms summed here, over the lanes with
    id >= 0 of the whole slab, ties to the larger id. Returns (scores
    [Gn, qt, kk] f32 descending, -inf = none; slots or ids [Gn, qt, kk]
    int32, -1 = none).

    The launcher picks one of two bodies by shape (`exact_topk_body`), never
    after a failure; both compute the same function. Shapes past
    `exact_topk_serves` raise."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if mode not in MODES:
        raise ValueError(f"exact_scan: mode must be 'slot' or 'id', got {mode!r}")
    if not use_kernel("exact_scan", qg):
        return exact_scan_plain(gp, qg, codes, kk, metric, mode, group_size, norms, ids)
    dtype = codes.dtype
    if not exact_topk_serves(qt, D, kk, dtype):
        raise ValueError(f"exact_scan: D={D}, qt={qt}, kk={kk} need more shared memory than "
                         "a block has (kernel K6 keeps 3 kk (score, index) pairs per row on the "
                         "tensor cores, round_up(kk, 32) + 128 on the CUDA cores)")
    aux = (("group_size", group_size, torch.int32, (Gn,)), ("norms", norms, torch.float32, (P, C))
           ) if mode == "slot" else (("ids", ids, torch.int32, (P, C)),)
    check_operands("exact_scan", qg.device, (("gp", gp, torch.int32, (Gn,)),
                                             ("qg", qg, dtype, (Gn, qt, D)),
                                             ("codes", codes, dtype, (P, C, D))) + aux,
                   qt, exact_topk_body(qt, D, kk, dtype) == MMA_BODY)
    out_s = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    out_i = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.int32)
    slot = mode == "slot"
    _ext.launch(launch_name("exact_topk", dtype), gp, group_size if slot else None, qg, codes,
                norms if slot else None, None if slot else ids, out_s, out_i, Gn, qt, D, P, C, kk,
                int(metric == "l2"), int(not slot), outputs=(out_s,))
    return out_s, out_i


def _exact_groups(q, pids, P: int, qt: int, dtype):
    """build_groups and the query tiles, rounded to the codes' dtype."""
    group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
    safe_q = torch.clamp(qlist, min=0).long()
    return group_pid, safe_q, round_query(q, dtype)[safe_q].contiguous(), pair_group, pair_slot


def grouped_scan_v3(codes, ids, sizes, norms, q, pids, k: int, metric: str, qt: int = 32):
    """v3 grouped scan (pallas_grouped.py::grouped_scan_pallas_v3): slot
    selection on exact scores, cached norms, size masking; ties among equal
    scores go to the larger slot. Kernel K6, mode "slot".

    codes [P, C, D] f32 or bf16, ids [P, C] int32, sizes [P] int32, norms
    [P, C] f32, q [B, D], pids [B, nprobe] int32 (-1 = pad). Returns (scores
    [B, k] f32, ids [B, k] int32, scanned [B] int32)."""
    P, C, _ = codes.shape
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, safe_q, qg, pair_group, pair_slot = _exact_groups(q, pids, P, qt, codes.dtype)
        gsafe = torch.clamp(group_pid, min=0).long()
        group_size = torch.where(group_pid >= 0, sizes[gsafe],
                                 torch.zeros_like(group_pid)).to(torch.int32).contiguous()
    with annotate("quake.scan"):
        g_scores, g_slots = exact_scan(group_pid, qg, codes, kk, metric, "slot",
                                       group_size=group_size, norms=norms)
    with annotate("quake.plan.merge"):
        # Epilogue: the per-query -|q|^2 back for l2 (-inf rows stay -inf), slot
        # -> vector id.
        if metric == "l2":
            qf = q.to(torch.float32)
            g_scores = g_scores - torch.sum(qf * qf, dim=1)[safe_q][:, :, None]
        g_ids = ids.reshape(-1)[gsafe[:, None, None] * C + torch.clamp(g_slots, min=0).long()]
        g_ids = torch.where(g_slots >= 0, g_ids, torch.full_like(g_ids, -1))
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk)


def grouped_scan_v2(codes, ids, q, pids, k: int, metric: str, qt: int = 64):
    """v2 grouped scan (pallas_grouped.py::grouped_scan_pallas): the whole
    slab per group, validity from the ids, both norms summed in the kernel,
    ties among equal scores to the larger id. Kernel K6, mode "id". Same
    returns as grouped_scan_v3."""
    P, C, _ = codes.shape
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, _, qg, pair_group, pair_slot = _exact_groups(q, pids, P, qt, codes.dtype)
    with annotate("quake.scan"):
        g_scores, g_ids = exact_scan(group_pid, qg, codes, kk, metric, "id", ids=ids)
    with annotate("quake.plan.merge"):
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk)
