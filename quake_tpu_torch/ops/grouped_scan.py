"""Partition-major grouped scan with the v11 placement epilogue — the
counterpart of the main-path part of quake_tpu/ops/pallas_grouped.py.

One call, `grouped_scan_v11`, turns probe lists into the per-query top-k:

  prologue   global quantization bounds, queries pre-scaled and norms
             pre-shifted so the kernel's key is one floor; groups from
             `build_groups_scatter` (v11_inputs: on CUDA tensors the four
             grouping kernels of csrc/group_tables.cu, group_tables_kernel)
  scan       kernel K1 (`grouped_scan_kernel`): per group, packed
             key*slot_mult + lane values, fold top-2 (fold 128 unless the
             caller names another, see `fold_served`), kk rounds
  placement  one sort (sorted) or argsort (argsort) lands each query's
             nprobe kernel rows contiguously
  merge      kernel K2 (`merge_positions`): per-query pool merge of the
             placed rows to kfin winner positions, or with merge="xla" the
             same fold-128 merge in tensor operations (no K2); with dedup (a
             spilled store) a top-2k of the pool's keys and each id's first
             occurrence instead (rescore_topk)
  rescore    exact f32 distances of the winners, final top-k; or, with
             exact=False (SearchParams.exact_distances=False), scores
             dequantized from the winners' keys and no rescore

`grouped_scan_v10` is the same scan with the v10 scatter placement, which
also serves pid matrices that hold -1 (fixed-nprobe semantics not promised).
`grouped_scan_v10b` is v10 with the group tables, K1's grid and the
placement sized to a pair budget instead of B*nprobe (the masked APS scans),
with the scatter or the budgeted sorted ("v11b") placement.

K1 and K2 are CUDA kernels (csrc/quake_kernels.cu), as is the prologue's
grouping (csrc/group_tables.cu); each wrapper runs its plain PyTorch version
on CPU tensors and launches the kernels on CUDA tensors.
On f32 codes K1 multiplies on the tensor cores with split TF32 operands that
keep f32 accuracy (ops/split_product.py is the plain model of that product);
on bf16 codes (the queries rounded to bf16, as in the JAX package) with one
bf16 product a depth-16 step, exact in its f32 accumulator.
Selection is approximate at the fold-column level (at most two winners per
fold column), as in the JAX package; parity tests assert row overlap.
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (budget_layout, build_groups_budget,
                                          build_groups_scatter, check_operands, group_layout,
                                          launch_name, operand_bytes, use_kernel)
from quake_tpu_torch.ops.scan import NEG_INF, duplicate_mask, topk_stable
from quake_tpu_torch.profiling import annotate

FOLD = 128
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def fold_served(fold: int) -> bool:
    """Whether kernels K1 and K5 serve fold width `fold` (csrc/common.cuh:
    32 and 64 fold a 128-column state further at a group's end; 128 m folds
    segment s into block s mod m, one block after another, for every m). The
    JAX kernels take any fold that divides C, the others in interpret mode
    only; here any other fold raises (check_fold), on every device."""
    return fold in (32, 64) or (fold > 0 and fold % FOLD == 0)


def check_fold(name: str, fold: int, C: int) -> None:
    """ValueError unless `fold` is served and divides C."""
    if not fold_served(fold):
        raise ValueError(f"{name}: fold={fold} is not served; the folds served are 32, 64 "
                         "and the multiples of 128")
    if C % fold:
        raise ValueError(f"{name} needs C % {fold} == 0 (C={C})")


def fold_list_len(fold: int, kk: int) -> int:
    """Values a row of the fold lists takes in K1's and K5's shared memory
    (csrc/common.cuh::fold_list_len): kk where fold = 128 m with m > 1."""
    return kk if fold > FOLD else 0


def grouped_scan_uses_mma(qt: int, D: int, dtype=torch.float32, fold: int = FOLD,
                          kk: int = 0) -> bool:
    """Whether kernel K1's launcher runs a tensor-core body at this shape,
    codes dtype and fold width (csrc/quake_kernels.cu::grouped_scan_uses_mma,
    asked of the built library): rows 16-byte aligned for the asynchronous
    copies (D % 4 == 0 in f32, D % 8 == 0 in bf16), and a whole-D query tile
    (and at fold = 128 m, m > 1, kk values a row of fold lists) that fits a
    block's shared memory beside the ring (f32: D up to 608 at qt = 64, 1408
    at qt = 32; bf16 twice that). Otherwise it runs the CUDA-core body of
    that dtype, which streams D in depth chunks and serves every D."""
    if dtype == torch.bfloat16:
        return bool(_ext.lib().qk_grouped_scan_bf16_uses_mma(qt, D, fold, kk))
    return bool(_ext.lib().qk_grouped_scan_uses_mma(qt, D, fold, kk))


def chunk_dots_smem(qt: int, D: int, lk: int = 0) -> int:
    """Bytes of shared memory of K1's CUDA-core body (csrc/quake_kernels.cu::
    chunk_dots_smem) with fold lists of lk values a row."""
    dcp = (min(D, 128) + 3) & ~3
    return (qt * dcp + FOLD * (dcp + 1) + qt * lk) * 4


def fold_rounds(packed, k: int, fold: int = FOLD):
    """Fold + max2 top-k rounds over a packed [R, C] matrix (plain version of
    pallas_grouped.py::_v7_fold_rounds). Returns out [R, k] packed,
    descending; -1 = none."""
    R, C = packed.shape
    m1 = packed[:, :fold]
    m2 = torch.full((R, fold), -1.0, device=packed.device, dtype=torch.float32)
    for s in range(1, C // fold):
        seg = packed[:, s * fold:(s + 1) * fold]
        m2 = torch.maximum(m2, torch.minimum(m1, seg))
        m1 = torch.maximum(m1, seg)
    out = torch.empty((R, k), device=packed.device, dtype=torch.float32)
    for i in range(k):
        best = m1.amax(dim=1, keepdim=True)
        out[:, i:i + 1] = best
        hit = m1 == best
        m1 = torch.where(hit, m2, m1)
        m2 = torch.where(hit, torch.full_like(m2, -1.0), m2)
    return out


def packed_params(C: int):
    """(slot_mult, levels) of the packed key*slot_mult + lane encoding: the
    largest key leaves every packed value below 2^24, exact in f32."""
    slot_mult = max(1 << int(C - 1).bit_length(), 2)
    return slot_mult, (1 << 24) // slot_mult - 2


def global_bounds(qf, norms, metric: str, bounds: str = "analytic", codes=None, sizes=None):
    """(gmin, grange) of the global quantization scale
    (pallas_grouped.py::_global_bounds), 0-d f32 tensors.

    "analytic": worst-case bounds from the batch max query norm and the
    store max vector norm. "sampled" (needs the store's codes [P, C, D] and
    sizes [P]): gmin from the scores of a stratified sample of at most 64
    queries (qf[::max(B // 64, 1)][:64]) against the valid lanes (lane <
    the partition's size) of the first min(P, 4) partitions, minus 25% of
    the range up to the analytic gmax, which stays (clamping at the top
    would corrupt winners; a key below gmin clamps to 0 and stays a
    candidate). The sample's product is a plain matmul in f32, codes
    upcast, as the JAX package computes it outside its kernels."""
    if bounds not in ("analytic", "sampled"):
        raise ValueError(f"bounds must be 'analytic' or 'sampled', not {bounds!r}")
    maxq2 = torch.sum(qf * qf, dim=1).max()
    maxx2 = torch.clamp(norms.max(), min=1e-12)
    maxqx = torch.sqrt(maxq2) * torch.sqrt(maxx2)
    if metric == "l2":
        gmax, gmin = maxq2, -(maxx2 + 2.0 * maxqx)
    else:
        gmax, gmin = maxqx, -maxqx
    if bounds == "sampled":
        if codes is None or sizes is None:
            raise ValueError("bounds='sampled' needs the store's codes and sizes")
        B = qf.shape[0]
        P, C, D = codes.shape
        sq = qf[::max(B // 64, 1)][:64]
        nps = min(P, 4)
        slab = codes[:nps].reshape(nps * C, D).to(torch.float32)
        prod = torch.matmul(sq, slab.T)
        scores = 2.0 * prod - norms[:nps].reshape(1, nps * C) if metric == "l2" else prod
        lane = torch.arange(nps * C, device=qf.device)[None, :]
        valid = (lane % C) < torch.repeat_interleave(sizes[:nps].long(), C)[None, :]
        smin = torch.where(valid, scores, torch.full_like(scores, float("inf"))).min()
        smin = torch.where(torch.isfinite(smin), smin, gmin)
        gmin = smin - 0.25 * torch.clamp(gmax - smin, min=1e-20)
    return gmin, torch.clamp(gmax - gmin, min=1e-20)


# ---------------------------------------------------------------- kernel K1


def grouped_scan_plain(gp, group_size, qg, codes, normsT, kk: int,
                       slot_mult: int, levels: int, fold: int = FOLD,
                       chunk: int = 256):
    """Plain PyTorch version of kernel K1 (same inputs and outputs as
    grouped_scan_kernel), computed `chunk` groups at a time. bf16 operands
    are upcast and multiplied in f32 (each product of two bf16 values is
    exact there; only the order of summation differs from the kernel's)."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    out = torch.full((Gn, qt, kk), -1.0, device=qg.device, dtype=torch.float32)
    lane = torch.arange(C, device=qg.device)
    for g0 in range(0, Gn, chunk):
        sl = slice(g0, min(g0 + chunk, Gn))
        size = group_size[sl]
        alive = torch.nonzero(size > 0).flatten()
        if alive.numel() == 0:
            continue
        p = gp[sl][alive].long()
        prod = torch.bmm(qg[sl][alive].to(torch.float32),
                         codes[p].to(torch.float32).transpose(1, 2))  # [a, qt, C]
        qk = torch.clamp(torch.floor(prod - normsT[p][:, None, :]), 0.0, float(levels))
        packed = qk * float(slot_mult) + lane.to(torch.float32)
        ok = (lane[None, :] < size[alive][:, None].long())[:, None, :]
        packed = torch.where(ok, packed, torch.full_like(packed, -1.0))
        a = alive.numel()
        out[g0 + alive] = fold_rounds(packed.reshape(a * qt, C), kk, fold).reshape(a, qt, kk)
    return out


def grouped_scan_kernel(gp, group_size, qg, codes, normsT, kk: int,
                        slot_mult: int, levels: int, fold: int = FOLD, budget: bool = False):
    """Kernel K1 (replaces pallas_grouped.py::_v9_kernel).

    gp [Gn] int32 partition per group; group_size [Gn] int32 (<= 0: ghost);
    qg [Gn, qt, D] queries scaled by q_coef, in the codes' dtype; codes [P,
    C, D] f32 or bf16; normsT [P, C] f32 norms shifted by gmin and scaled by
    ginv. Returns [Gn, qt, kk] f32 packed key*slot_mult + lane per row,
    descending (-1 = none; ghost groups are all -1).

    fold: the fold width, one of `fold_served`'s, dividing C (check_fold
    raises otherwise); the launches count under the same names at every
    fold.

    The launcher picks one of two bodies a dtype by shape
    (`grouped_scan_uses_mma`): the tensor-core body (asynchronous copies; in
    f32 the split TF32 product, in bf16 one bf16 product a depth-16 step)
    where a row is 16-byte aligned (D % 4 == 0 in f32, D % 8 == 0 in bf16)
    and the whole-D query tile fits beside its ring, the CUDA-core body (f32
    arithmetic, D in depth chunks: every D) otherwise. Both compute the same
    function; neither is a fallback from a failure. bf16 launches count
    under "grouped_scan_bf16"; with budget (the grid of the budgeted scan,
    grouped_scan_v10b, which replaces pallas_grouped.py::
    grouped_scan_pallas_v10b's launch of _v9_kernel) they count under
    "grouped_scan_budget" (f32) or "grouped_scan_budget_bf16"."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    check_fold("grouped_scan_kernel", fold, C)
    if not use_kernel("grouped_scan_kernel", qg):
        return grouped_scan_plain(gp, group_size, qg, codes, normsT, kk,
                                  slot_mult, levels, fold)
    cdt = codes.dtype
    mma = grouped_scan_uses_mma(qt, D, cdt, fold, kk)
    if not mma and chunk_dots_smem(qt, D, fold_list_len(fold, kk)) > SMEM_LIMIT:
        raise ValueError(f"grouped_scan_kernel: qt={qt}, D={D}, kk={kk} at fold={fold} need "
                         "more shared memory than a block has (kk fold-list values a row)")
    check_operands("grouped_scan_kernel", qg.device, (
        ("gp", gp, torch.int32, (Gn,)),
        ("group_size", group_size, torch.int32, (Gn,)),
        ("qg", qg, cdt, (Gn, qt, D)),
        ("codes", codes, cdt, (P, C, D)),
        ("normsT", normsT, torch.float32, (P, C))), qt, mma)
    out = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    _ext.launch(launch_name("grouped_scan", cdt), gp, group_size, qg, codes, normsT, out,
                Gn, qt, D, P, C, kk, float(slot_mult), float(levels), int(fold),
                count=launch_name("grouped_scan_budget", cdt) if budget else None, outputs=(out,))
    return out


# ---------------------------------------------------------------- kernel K2


def pool_lane_mult(pool: int) -> int:
    """lane_mult of the pool merge's packed key*lane_mult + lane: the pool
    width padded to a multiple of 128 (at least 2)."""
    return max(-(-pool // FOLD) * FOLD, 2)


def pool_keys(m_packed, slot_mult: int):
    """Integer keys [B, pool] f32 of the placed pool values: floor(m /
    slot_mult), -1 where m is -1 (no candidate)."""
    return torch.where(m_packed >= 0.0, torch.floor(m_packed / float(slot_mult)),
                       torch.full_like(m_packed, -1.0))


def merge_positions_plain(m_packed, kfin: int, slot_mult: int, fold: int = FOLD):
    """Plain PyTorch version of kernel K2 (same inputs and outputs as
    merge_positions). It is also the merge="xla" pool merge of pool_tail
    (pallas_grouped.py::_pool_tail's and _global_epilogue's non-kernel
    branch, the fold-128 top-2 and kfin rounds in XLA operations), on every
    device: its positions equal K2's bit for bit."""
    B, pool = m_packed.shape
    lane_mult = pool_lane_mult(pool)
    keys = pool_keys(m_packed, slot_mult)
    lane = torch.arange(pool, device=m_packed.device, dtype=torch.float32)
    packed = torch.where(keys >= 0.0, keys * float(lane_mult) + lane[None, :],
                         torch.full_like(keys, -1.0))
    poolp = -(-pool // fold) * fold
    packed = torch.nn.functional.pad(packed, (0, poolp - pool), value=-1.0)
    out = fold_rounds(packed, kfin, fold)
    pos = torch.remainder(out, float(lane_mult)).to(torch.int32)
    return torch.where(out >= 0.0, pos, torch.full_like(pos, -1))


def merge_positions(m_packed, kfin: int, slot_mult: int, fold: int = FOLD):
    """Kernel K2 (replaces pallas_grouped.py::_merge_positions_kernel, with
    the key step of _pool_tail before it).

    m_packed [B, pool] f32: the placed pool of packed key*slot_mult + slot
    values (-1 = none), as the placement leaves it; slot_mult a power of
    two. The key floor(m / slot_mult) is packed as key*lane_mult + lane
    (lane_mult = pool_lane_mult(pool), the pool padded to a 128 multiple,
    whose padding reads as -1), folded to 128 columns (top-2 each) and
    selected in kfin rounds. Returns winner positions [B, kfin] int32
    (-1 = none)."""
    B, pool = m_packed.shape
    if fold != FOLD:
        raise ValueError(f"merge_positions needs fold == 128 (fold={fold})")
    if not use_kernel("merge_positions", m_packed):
        return merge_positions_plain(m_packed, kfin, slot_mult, fold)
    check_operands("merge_positions", m_packed.device,
                   (("m_packed", m_packed, torch.float32, (B, pool)),))
    if slot_mult < 1 or slot_mult & (slot_mult - 1):
        raise ValueError(f"merge_positions: slot_mult must be a power of two ({slot_mult})")
    out = torch.empty((B, kfin), device=m_packed.device, dtype=torch.int32)
    _ext.launch("merge_positions", m_packed, out, B, pool, kfin, pool_lane_mult(pool),
                1.0 / slot_mult)
    return out


# ------------------------------------------------------------ epilogue tail


def _flat_row_take(arr_pc, pid, slot):
    """arr[pid, slot] for [P, C, ...] arrays through one flattened take."""
    C = arr_pc.shape[1]
    flat = arr_pc.reshape((-1,) + tuple(arr_pc.shape[2:]))
    return flat[pid.long() * C + slot.long()]


def _pad_k(scores, out_ids, k: int):
    """Reference -inf / -1 padding of [B, < k] results to [B, k]."""
    if scores.shape[1] < k:
        padn = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, padn), value=NEG_INF)
        out_ids = torch.nn.functional.pad(out_ids, (0, padn), value=-1)
    return scores, out_ids


def _scanned(pids):
    return torch.sum((pids >= 0).to(torch.int32), dim=1, dtype=torch.int32)


def dequantized_tail(keys, top_refs, ids, q, k: int, metric: str, pids, gmin, ginv):
    """Scores of the winners rebuilt from their global-scale keys, with no
    vector gather (the exact=False tail of pallas_grouped.py::_pool_tail
    and _rescore_topk): score = (key + 0.5) / ginv + gmin, minus |q|^2 of
    the f32 query for l2; the winners keep the merge's order. keys,
    top_refs [B, kfin] ((pid << 16 | slot), -1 = none). Returns (scores
    [B, k] f32, ids [B, k] int32, scanned [B] int32)."""
    score = (keys + 0.5) / ginv + gmin
    if metric == "l2":
        qf = q.to(torch.float32)
        score = score - torch.sum(qf * qf, dim=1, keepdim=True)
    ok = top_refs >= 0  # a -1 ref reads slot (0, 0), masked here
    top_ids = _flat_row_take(ids, torch.clamp(top_refs >> 16, min=0),
                             torch.where(ok, top_refs & 0xFFFF, torch.zeros_like(top_refs)))
    top_ids = torch.where(ok, top_ids, torch.full_like(top_ids, -1))
    score = torch.where(top_ids >= 0, score, torch.full_like(score, NEG_INF))
    scores, out_ids = _pad_k(score[:, :k], top_ids[:, :k], k)
    return scores, out_ids.to(torch.int32), _scanned(pids)


def exact_rescore(top_refs, codes, ids, norms, q, k: int, kfin: int,
                  metric: str, pids):
    """Exact rescore of (pid << 16 | slot) winners + reference padding.
    Returns (scores [B, k] f32, ids [B, k] int32, scanned [B] int32)."""
    # -1 refs read slot (0, 0); their results are masked below.
    w_pid = torch.clamp(top_refs >> 16, min=0)
    w_slot = torch.where(top_refs >= 0, top_refs & 0xFFFF, torch.zeros_like(top_refs))
    vecs = _flat_row_take(codes, w_pid, w_slot).to(torch.float32)  # [B, kfin, D]
    qf = q.to(torch.float32)
    prod = torch.bmm(vecs, qf[:, :, None])[:, :, 0]
    if metric == "l2":
        exact = (2.0 * prod - torch.sum(qf * qf, dim=1, keepdim=True)
                 - _flat_row_take(norms, w_pid, w_slot))
    else:
        exact = prod
    top_ids = _flat_row_take(ids, w_pid, w_slot)
    top_ids = torch.where(top_refs >= 0, top_ids, torch.full_like(top_ids, -1))
    exact = torch.where(top_ids >= 0, exact, torch.full_like(exact, NEG_INF))
    scores, order = topk_stable(exact, min(kfin, max(k, 1)))
    out_ids = torch.gather(top_ids, 1, order)
    scores, out_ids = scores[:, :k], out_ids[:, :k]
    out_ids = torch.where(torch.isfinite(scores), out_ids, torch.full_like(out_ids, -1))
    scores = torch.where(out_ids >= 0, scores, torch.full_like(scores, NEG_INF))
    scores, out_ids = _pad_k(scores, out_ids, k)
    return scores, out_ids.to(torch.int32), _scanned(pids)


def rescore_topk(m_scores, m_refs, codes, ids, norms, q, k: int, kk: int,
                 metric: str, pids, dedup: bool = False, exact: bool = True,
                 gmin=None, ginv=None):
    """General merge tail (pallas_grouped.py::_rescore_topk): top-k by pool
    score, then the exact rescore of the winners, or with exact=False their
    scores dequantized from the keys (m_scores, given the global scale's
    gmin and ginv). kk (the per-group candidate count) is part of the JAX
    signature and unused, as there.

    dedup (a spilled store, each vector resident in two partitions): the
    top min(2k, pool) by key, each id kept at its first occurrence in key
    order (the copies are the same vector, so which one survives does not
    matter), the first k survivors compacted to the front in that order;
    then the exact rescore of those, or their dequantized keys."""
    if not dedup:
        top_scores, idx = topk_stable(m_scores, k)
        top_refs = torch.gather(m_refs, 1, idx)
        if not exact:
            return dequantized_tail(top_scores, top_refs, ids, q, k, metric, pids, gmin, ginv)
        return exact_rescore(top_refs, codes, ids, norms, q, k,
                             min(k, idx.shape[1]), metric, pids)
    pool = min(2 * k, m_scores.shape[1])
    s_pool, idx = topk_stable(m_scores, pool)
    top_refs = torch.gather(m_refs, 1, idx)
    ok = top_refs >= 0
    c_ids = _flat_row_take(ids, torch.clamp(top_refs >> 16, min=0),
                           torch.where(ok, top_refs & 0xFFFF, torch.zeros_like(top_refs)))
    c_ids = torch.where(ok, c_ids, torch.full_like(c_ids, -1))
    is_dup = duplicate_mask(c_ids)
    # Survivor j lands at its rank among the survivors; duplicates fall out.
    kfin = min(k, pool)
    keep_rank = torch.cumsum((~is_dup).to(torch.int64), dim=1) - 1
    sel = torch.where(is_dup, torch.full_like(keep_rank, pool), keep_rank)
    lane = torch.arange(kfin, device=sel.device)
    match = sel[:, None, :] == lane[None, :, None]  # [B, kfin, pool]
    refs_kept = torch.amax(torch.where(match, top_refs[:, None, :], -1), dim=2)
    if exact:
        return exact_rescore(refs_kept, codes, ids, norms, q, k, kfin, metric, pids)
    keys_kept = torch.amax(torch.where(match, s_pool[:, None, :], NEG_INF), dim=2)
    return dequantized_tail(keys_kept, refs_kept, ids, q, k, metric, pids, gmin, ginv)


def pool_tail(m_packed, pid_cols, pids, codes, ids, norms, q, k: int, kk: int,
              metric: str, slot_mult: int, levels: int, pool_factor: int = 1,
              general: bool = False, exact: bool = True, gmin=None,
              ginv=None, dedup: bool = False, merge: str = "pallas"):
    """Pool side of the v11 epilogues (pallas_grouped.py::_pool_tail) and of
    the v8/v9 one (_global_epilogue): key merge, winner ref derivation,
    exact rescore, or with exact=False (v10 and v11 only) the winners'
    scores dequantized from their keys with the global scale's gmin and
    ginv (dequantized_tail). pid_cols [B, nprobe] maps pool column
    j -> j // kk -> the query's partition (ascending pids for the sorted
    placement, probe order for argsort and v8/v9); pids is only used for
    the scanned count. merge "pallas" merges the pool on kernel K2, "xla"
    in tensor operations (merge_positions_plain, on every device; the same
    positions); any other value raises ValueError, where the JAX package
    takes every value but "pallas" as "xla". general forces the top-k merge
    instead; dedup (a spilled store) takes it too, with rescore_topk's
    dedup."""
    if merge not in ("pallas", "xla"):
        raise ValueError(f"merge must be 'pallas' or 'xla', not {merge!r}")
    B, nprobe = pids.shape
    pool = nprobe * kk
    lane_mult = pool_lane_mult(pool)
    if general or dedup or levels * lane_mult + lane_mult >= (1 << 24):
        # General path: key*lane_mult + lane no longer fits 24 bits (or the
        # caller asks for it, or dedup needs the pool-side refs), so the
        # pool is ranked by a top-k of the keys instead of kernel K2.
        with annotate("quake.plan.merge"):
            slot = torch.remainder(m_packed, float(slot_mult)).to(torch.int32)
            pid_b = pid_cols[:, :, None].expand(B, nprobe, kk).reshape(B, pool)
            ok = (m_packed >= 0.0) & (pid_b >= 0)
            m_refs = torch.where(ok, (torch.clamp(pid_b, min=0) << 16) | slot,
                                 torch.full_like(slot, -1))
            m_scores = torch.where(ok, pool_keys(m_packed, slot_mult),
                                   torch.full_like(m_packed, NEG_INF))
        with annotate("quake.plan.rescore"):
            return rescore_topk(m_scores, m_refs, codes, ids, norms, q, k, kk, metric, pids,
                                dedup=dedup, exact=exact, gmin=gmin, ginv=ginv)

    with annotate("quake.plan.merge"):
        kfin = min(pool_factor * k, pool)
        merge_fn = merge_positions if merge == "pallas" else merge_positions_plain
        pos = merge_fn(m_packed, kfin, slot_mult)
        posc = torch.clamp(pos, 0, pool - 1).long()
        pk = torch.gather(m_packed, 1, posc)
        slot = torch.remainder(pk, float(slot_mult)).to(torch.int32)
        wpid = torch.gather(pid_cols, 1, posc // kk)
        valid = (pos >= 0) & (pk >= 0.0) & (wpid >= 0)
        top_refs = torch.where(valid, (torch.clamp(wpid, min=0) << 16) | slot,
                               torch.full_like(slot, -1))
    with annotate("quake.plan.rescore"):
        if exact:
            return exact_rescore(top_refs, codes, ids, norms, q, k, kfin, metric, pids)
        return dequantized_tail(torch.floor(pk / float(slot_mult)), top_refs, ids, q, k, metric,
                                pids, gmin, ginv)


def _alive_rows(g_packed, group_size):
    """[R, kk] kernel rows with ghost (size-0) groups masked to -1."""
    Gn, qt, kk = g_packed.shape
    alive = (group_size > 0)[:, None, None]
    return torch.where(alive, g_packed, torch.full_like(g_packed, -1.0)).reshape(Gn * qt, kk)


def sorted_placement(g_packed, tgt, group_size, pids):
    """v11 SORTED placement (pallas_grouped.py::_sorted_epilogue): rows
    sorted by the key (query << r_bits) | row land each query's nprobe rows
    contiguously, in ascending-partition order. Returns (m_packed
    [B, nprobe*kk], pid_cols = the per-query ascending pid sort)."""
    B, nprobe = pids.shape
    n = B * nprobe
    rows = _alive_rows(g_packed, group_size)
    R = rows.shape[0]
    r_bits = max((R - 1).bit_length(), 1)
    tgt_flat = tgt.reshape(-1).to(torch.int64)
    iota = torch.arange(R, device=rows.device, dtype=torch.int64)
    key2 = torch.where(tgt_flat < n, ((tgt_flat // nprobe) << r_bits) | iota,
                       torch.full_like(iota, 0xFFFFFFFF))
    ks = torch.sort(key2).values
    r_sorted = (ks & ((1 << r_bits) - 1))[:n]
    m_packed = rows[r_sorted].reshape(B, nprobe * rows.shape[1])
    return m_packed, torch.sort(pids, dim=1).values


def argsort_placement(g_packed, tgt, group_size, pids):
    """v11 ARGSORT placement (pallas_grouped.py::_argsort_epilogue): under
    dense fixed-nprobe semantics tgt covers [0, n) exactly once, so
    argsort(tgt)[:n] is the row -> pair placement at any shape; the pool
    lands in probe order (pid_cols = pids)."""
    B, nprobe = pids.shape
    n = B * nprobe
    rows = _alive_rows(g_packed, group_size)
    order = torch.argsort(tgt.reshape(-1), stable=True)[:n]
    return rows[order].reshape(B, nprobe * rows.shape[1]), pids


def scatter_placement(g_packed, tgt, group_size, pids):
    """v10 SCATTER placement (pallas_grouped.py::_scatter_epilogue): each
    kernel row lands at its pair's row m_packed[tgt] of a [B*nprobe + 1, kk]
    buffer pre-filled with -1, whose last row discards the rows of padding
    and of ghost (size-0) groups. Pairs whose pid is -1 keep -1 rows; the
    pool lands in probe order (pid_cols = pids)."""
    B, nprobe = pids.shape
    n = B * nprobe
    Gn, qt, kk = g_packed.shape
    tgt = torch.where((group_size > 0)[:, None], tgt, torch.full_like(tgt, n))
    mp = torch.full((n + 1, kk), -1.0, device=g_packed.device, dtype=torch.float32)
    mp[tgt.reshape(-1).long()] = g_packed.reshape(Gn * qt, kk)
    return mp[:n].reshape(B, nprobe * kk), pids


def sorted_budget_placement(g_packed, tgt, group_size, pids):
    """v11b SORTED placement of a budgeted masked scan (the placement half of
    pallas_grouped.py::_sorted_budget_epilogue): query b owns c_b rows, one
    per valid pid of its row. One sort of the key (query << r_bits) | row
    (int64: CUDA torch has no uint32 sort; the order is the uint32 one) lays
    each query's rows contiguously in ascending-partition order, at
    [cum_b, cum_b + c_b) with cum the exclusive prefix of the c_b; pool
    column j of query b is row cum_b + j where j < c_b, -1 past it: one
    [B*W, kk] row take, no B*W-sized scatter. Ghost-group rows keep their
    place and read -1. Returns (m_packed [B, W*kk], pid_cols = each row's
    valid pids in ascending order, -1 past c_b)."""
    B, W = pids.shape
    n = B * W
    rows = _alive_rows(g_packed, group_size)
    R = rows.shape[0]
    r_bits = max((R - 1).bit_length(), 1)
    tgt_flat = tgt.reshape(-1).to(torch.int64)
    iota = torch.arange(R, device=rows.device, dtype=torch.int64)
    key2 = torch.where(tgt_flat < n, ((tgt_flat // W) << r_bits) | iota,
                       torch.full_like(iota, 0xFFFFFFFF))
    r_sorted = torch.sort(key2).values & ((1 << r_bits) - 1)
    c_b = torch.sum((pids >= 0).to(torch.int64), dim=1)
    cum = torch.cumsum(c_b, 0) - c_b
    j_lane = torch.arange(W, device=rows.device, dtype=torch.int64)[None, :]
    gate = j_lane < c_b[:, None]
    pos = torch.clamp(cum[:, None] + j_lane, 0, R - 1)
    r_final = torch.where(gate, r_sorted[pos], torch.zeros_like(pos)).reshape(-1)
    m_rows = rows[r_final]
    m_packed = torch.where(gate.reshape(-1)[:, None], m_rows, torch.full_like(m_rows, -1.0))
    sorted_pids = torch.sort(torch.where(pids >= 0, pids, torch.full_like(pids, 1 << 30)),
                             dim=1).values
    pid_cols = torch.where(gate, sorted_pids, torch.full_like(sorted_pids, -1))
    return m_packed.reshape(B, W * rows.shape[1]), pid_cols


# The placements of the kernel rows per query, by name; the budgeted scan's.
PLACEMENTS = {"sorted": sorted_placement, "argsort": argsort_placement,
              "scatter": scatter_placement}
BUDGET_PLACEMENTS = {"sorted": sorted_budget_placement, "scatter": scatter_placement}


# ---------------------------------------------------------------- the scan


def sort_key_fits(B: int, rows: int) -> bool:
    """True when the sorted placement's key (query << r_bits) | row fits
    uint32 strictly below the 0xFFFFFFFF invalid marker (the JAX package's
    bit budget, kept so both packages place identically)."""
    return max((rows - 1).bit_length(), 1) + max((B - 1).bit_length(), 1) < 32


def budget_sort_key_fits(B: int, M: int, n_bud: int, P: int, qt: int, gpb: int) -> bool:
    """True when the v11b sorted placement's key (query << r_bits) | row fits
    uint32 strictly below the 0xFFFFFFFF invalid marker on a grid budgeted
    for n_bud pairs (pallas_grouped.py::budget_sort_key_fits; kept so both
    packages pick the same placement)."""
    G = budget_layout(min(n_bud, B * M), P, qt)
    return sort_key_fits(B, -(-G // gpb) * gpb * qt)


def global_scale(q, norms, metric: str, levels: int, bounds: str = "analytic", codes=None,
                 sizes=None):
    """The v8/v9/v11 pre-transforms: key = (score - gmin) * ginv moves
    entirely into scaled queries (the score's <q, x> coefficient times
    ginv) and shifted norms ((|x|^2 +) gmin, times ginv), so the kernel's
    quantize is floor(<q', x> - normsT). Returns (q_scaled [B, D] f32,
    normsT [P, C] f32, gmin, ginv), the last two 0-d f32 tensors (the
    dequantized tail's scale). bounds as global_bounds (codes and sizes
    for "sampled")."""
    qf = q.to(torch.float32)
    gmin, grange = global_bounds(qf, norms, metric, bounds, codes, sizes)
    ginv = float(levels) / grange
    q_coef = 2.0 * ginv if metric == "l2" else ginv
    base = norms if metric == "l2" else torch.zeros_like(norms)
    return qf * q_coef, ((base + gmin) * ginv).contiguous(), gmin, ginv


def pad_groups(group_pid, qlist, sizes, gpb: int):
    """Pads the group tables to Gn = ceil(G/gpb)*gpb groups (gp -1, qlist
    -1). Returns (gp, ql, group_size int32 with 0 for unused groups,
    safe_q = the query row of each kernel row, 0 for padding)."""
    pad = -(-group_pid.shape[0] // gpb) * gpb - group_pid.shape[0]
    gp = torch.nn.functional.pad(group_pid, (0, pad), value=-1).contiguous()
    ql = torch.nn.functional.pad(qlist, (0, 0, 0, pad), value=-1)
    group_size = torch.where(gp >= 0, sizes[torch.clamp(gp, min=0).long()],
                             torch.zeros_like(gp)).to(torch.int32).contiguous()
    return gp, ql, group_size, torch.clamp(ql, min=0).long()


def group_tables_plain(codes, sizes, norms, q, pids, metric: str, qt: int, gpb: int,
                       levels: int, bounds: str = "analytic", pair_budget: int = 0):
    """Plain PyTorch version of the grouping kernels (same inputs and
    outputs as group_tables_kernel): global_scale, build_groups_scatter or
    (pair_budget > 0) build_groups_budget, pad_groups and the query
    gather."""
    B, P = q.shape[0], codes.shape[0]
    q_scaled, normsT, gmin, ginv = global_scale(q, norms, metric, levels, bounds, codes, sizes)
    if pair_budget > 0:
        group_pid, qlist, tgt = build_groups_budget(pids, P, qt, pair_budget)
    else:
        group_pid, qlist, tgt = build_groups_scatter(pids, P, qt)
    gp, _, group_size, safe_q = pad_groups(group_pid, qlist, sizes, gpb)
    tgt = torch.nn.functional.pad(tgt, (0, 0, 0, gp.shape[0] - tgt.shape[0]),
                                  value=B * pids.shape[1])
    qg = q_scaled.to(codes.dtype)[safe_q].contiguous()  # [Gn, qt, D]
    return dict(gp=gp, group_size=group_size, qg=qg, normsT=normsT, tgt=tgt, gmin=gmin,
                ginv=ginv)


GROUP_TILE = 2048  # pairs a warp of group_count and group_scatter takes, at least


def group_tables_kernel(codes, sizes, norms, q, pids, metric: str, qt: int, gpb: int,
                        levels: int, bounds: str = "analytic", pair_budget: int = 0):
    """The grouping prologue in four CUDA launches (csrc/group_tables.cu:
    group_count, group_scan, group_scatter, group_tables), after PyTorch's
    |q|^2 row sums, whose order of summation global_scale's bounds take.
    Returns group_tables_plain's dict, equal to it bit for bit: gp,
    group_size, tgt ([Gn, qt], Gn = ceil(G/gpb)*gpb), qg, normsT, gmin and
    ginv (0-d views of one buffer). The pairs of a partition are counted
    and placed in tiles of GROUP_TILE pairs (more where P is larger, so the
    tile counts stay within n + P). bounds="sampled" takes global_bounds'
    gmin and grange, computed in PyTorch, and group_count then reduces no
    maxima."""
    B, D = q.shape
    P, C, _ = codes.shape
    M = pids.shape[1]
    n = B * M
    n_bud = min(int(pair_budget), n) if pair_budget > 0 else 0
    G = budget_layout(n_bud, P, qt) if n_bud > 0 else group_layout(B, M, P, qt)
    Gn = -(-G // gpb) * gpb
    dev = q.device
    qf = q.to(torch.float32).contiguous()
    pids, sizes = pids.to(torch.int32).contiguous(), sizes.to(torch.int32).contiguous()
    check_operands("group_tables_kernel", dev, (
        ("pids", pids, torch.int32, (B, M)), ("sizes", sizes, torch.int32, (P,)),
        ("q", qf, torch.float32, (B, D)), ("norms", norms, torch.float32, (P, C))), qt)
    if bounds not in ("analytic", "sampled"):
        raise ValueError(f"bounds must be 'analytic' or 'sampled', not {bounds!r}")
    tile = max(GROUP_TILE, -(-P // 256) * 256)
    ntiles = -(-n // tile)
    if bounds == "sampled":  # no maxima to reduce: group_scan takes these bounds
        sampled, rowsq, nred = global_bounds(qf, norms, metric, bounds, codes, sizes), None, 0
    else:
        sampled, rowsq = (None, None), torch.sum(qf * qf, dim=1)
        nred = min(1024, max(-(-P * C // 4096), -(-B // 512)))  # blocks of maxima, 32 threads
    nnorm = min(1024, -(-P * C // 4096))  # blocks of normsT, 256 threads
    ws = torch.empty(ntiles * P + 3 * P, device=dev, dtype=torch.int32)
    hist, run, gbase, gend = ws[:ntiles * P], *ws[ntiles * P:].view(3, P)
    fws = torch.empty(2 + 2 * nred, device=dev, dtype=torch.float32)
    scale, partials = fws[:2], fws[2:]
    gp = torch.empty(Gn, device=dev, dtype=torch.int32)
    group_size = torch.empty(Gn, device=dev, dtype=torch.int32)
    tgt = torch.empty((Gn, qt), device=dev, dtype=torch.int32)
    qg = torch.empty((Gn, qt, D), device=dev, dtype=codes.dtype)
    normsT = torch.empty((P, C), device=dev, dtype=torch.float32)
    l2 = int(metric == "l2")
    _ext.launch("group_count", pids, rowsq, norms, hist, partials, n, P, tile, ntiles, B, P * C,
                nred)
    _ext.launch("group_scan", hist, run, gbase, gend, partials, *sampled, scale, ntiles, P,
                n_bud, qt, l2, float(levels), nred)
    _ext.launch("group_scatter", pids, hist, run, gbase, tgt, n, P, tile, ntiles, qt)
    _ext.launch("group_tables", run, gbase, gend, sizes, qf, norms, scale, gp, group_size, tgt,
                qg, normsT, P, P * C, Gn, qt, n, M, D, operand_bytes(codes.dtype), l2, nnorm,
                outputs=(qg, normsT))
    return dict(gp=gp, group_size=group_size, qg=qg, normsT=normsT, tgt=tgt, gmin=scale[0],
                ginv=scale[1])


def v11_inputs(codes, sizes, norms, q, pids, k: int, metric: str, qt: int,
               gpb: int, bounds: str = "analytic", pair_budget: int = 0):
    """Prologue of grouped_scan_v11, _v10 and (pair_budget > 0) _v10b:
    everything kernel K1, the placement and the tail need. Returns a dict
    with gp, group_size, qg (the scaled queries rounded to the codes' dtype,
    as the JAX package rounds them), normsT, tgt (padded to Gn =
    ceil(G/gpb)*gpb groups; G from build_groups_budget's budget_layout where
    pair_budget > 0), kk, slot_mult, levels, gmin and ginv: from the
    grouping kernels on CUDA tensors (group_tables_kernel), from their plain
    version on CPU tensors."""
    C = codes.shape[1]
    slot_mult, levels = packed_params(C)
    tables = group_tables_kernel if use_kernel("group_tables", q) else group_tables_plain
    return dict(tables(codes, sizes, norms, q, pids, metric, qt, gpb, levels, bounds,
                       pair_budget),
                kk=min(k, C), slot_mult=slot_mult, levels=levels)


def _placed_scan(name: str, codes, ids, sizes, norms, q, pids, k: int, metric: str,
                  qt: int, gpb: int, fold: int, dedup: bool, pool_factor: int, bounds: str,
                  merge: str, exact: bool, placement: str, pair_budget: int = 0):
    """The scan of v10, v11 and v10b: the prologue, kernel K1 at fold width
    `fold` (check_fold), the placement epilogue named `placement` (see
    PLACEMENTS; BUDGET_PLACEMENTS with pair_budget > 0), the pool tail (K2,
    or merge="xla"; exact rescore, or dequantized scores with exact=False).
    dedup (a spilled store) takes the pool tail's general path, a top-k of
    the pool's keys with the dedup of rescore_topk, as the JAX package does:
    kernel K2 does not run."""
    B, D = q.shape
    P, C, _ = codes.shape
    with annotate("quake.plan.grouping"):
        if P >= 32768 or C > 65536:
            raise ValueError(f"{name} packs (pid, slot) into int32: needs P < 32768, "
                             "C <= 65536")
        check_fold(name, fold, C)
        M = pids.shape[1]
        if pair_budget > 0:
            if placement == "sorted" and not budget_sort_key_fits(B, M, pair_budget, P, qt,
                                                                  gpb):
                G = budget_layout(min(pair_budget, B * M), P, qt)
                raise ValueError(f"v11b sort key overflows uint32 (B={B}, rows="
                                 f"{-(-G // gpb) * gpb * qt}); use placement='scatter'")
        elif placement == "sorted":
            G = group_layout(B, M, P, qt)
            Gn = -(-G // gpb) * gpb
            if not sort_key_fits(B, Gn * qt):
                raise ValueError(f"v11 sort key overflows uint32 (B={B}, rows={Gn * qt}); "
                                 "use placement='argsort'")
        inp = v11_inputs(codes, sizes, norms, q, pids, k, metric, qt, gpb, bounds, pair_budget)
    kk, slot_mult, levels = inp["kk"], inp["slot_mult"], inp["levels"]
    kargs = (inp["gp"], inp["group_size"], inp["qg"], codes, inp["normsT"], kk, slot_mult,
             levels, fold)
    with annotate("quake.scan"):
        g_packed = (grouped_scan_kernel(*kargs, budget=True) if pair_budget > 0
                    else grouped_scan_kernel(*kargs))
    with annotate("quake.plan.placement"):
        place = (BUDGET_PLACEMENTS if pair_budget > 0 else PLACEMENTS)[placement]
        m_packed, pid_cols = place(g_packed, inp["tgt"], inp["group_size"], pids)
    return pool_tail(m_packed, pid_cols, pids, codes, ids, norms, q, k, kk, metric, slot_mult,
                     levels, pool_factor, exact=exact, gmin=inp["gmin"], ginv=inp["ginv"],
                     dedup=dedup, merge=merge)


def grouped_scan_v11(codes, ids, sizes, norms, q, pids, k: int, metric: str,
                     qt: int = 64, gpb: int = 4, fold: int = FOLD,
                     dedup: bool = False, pool_factor: int = 1,
                     bounds: str = "analytic", merge: str = "pallas",
                     exact: bool = True, placement: str = "sorted"):
    """v11 grouped scan (pallas_grouped.py::grouped_scan_pallas_v11): kernel
    K1 with the sorted (or argsort) placement epilogue. DENSE-ONLY: every
    pid must be valid (fixed-nprobe semantics).

    codes [P, C, D] f32 or bf16, ids [P, C] int32, sizes [P] int32, norms
    [P, C] f32, q [B, D], pids [B, nprobe] int32. Returns (scores [B, k] f32,
    ids [B, k] int32, scanned [B] int32): exact distances of the winners,
    or with exact=False scores dequantized from their keys (within one
    quantization step, grange / levels). fold: K1's fold width (32, 64 or a
    multiple of 128 that divides C; see fold_served); merge: "pallas" (K2)
    or "xla" (the same merge in tensor operations, see pool_tail). Each
    stage runs in a span of its own (quake.plan.grouping, quake.scan,
    quake.plan.placement, quake.plan.merge, quake.plan.rescore; see
    quake_tpu_torch.profiling)."""
    if placement not in ("sorted", "argsort"):
        raise ValueError(f"v11 placement must be 'sorted' or 'argsort', got {placement!r}")
    return _placed_scan("v11", codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, fold,
                         dedup, pool_factor, bounds, merge, exact, placement)


def grouped_scan_v10(codes, ids, sizes, norms, q, pids, k: int, metric: str,
                     qt: int = 64, gpb: int = 4, fold: int = FOLD,
                     dedup: bool = False, pool_factor: int = 1,
                     bounds: str = "analytic", merge: str = "pallas",
                     exact: bool = True):
    """v10 grouped scan (pallas_grouped.py::grouped_scan_pallas_v10): kernel
    K1 with the scatter placement epilogue. pids may hold -1 (a pair that
    takes no part); inputs and returns as grouped_scan_v11."""
    return _placed_scan("v10", codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, fold,
                         dedup, pool_factor, bounds, merge, exact, "scatter")


def grouped_scan_v10b(codes, ids, sizes, norms, q, pids, k: int, metric: str,
                      pair_budget: int, qt: int = 64, gpb: int = 4, fold: int = FOLD,
                      dedup: bool = False, pool_factor: int = 1,
                      bounds: str = "analytic", merge: str = "pallas",
                      exact: bool = True, placement: str = "scatter"):
    """v10b grouped scan (pallas_grouped.py::grouped_scan_pallas_v10b): v10
    with its group tables (build_groups_budget), kernel K1's grid and the
    placement sized to a PAIR BUDGET instead of B*nprobe, for the masked
    APS scans, where the plan covers a per-query prefix much shorter than
    the candidate width. K1 runs its usual body on the budget grid (ghost
    groups write -1); its launches count under "grouped_scan_budget" (f32)
    or "grouped_scan_budget_bf16".

    CONTRACT: at most pair_budget pids of the matrix are valid (aps_oneshot's
    and aps_plan's plan clipping enforce it); more would be dropped.
    placement "scatter" routes the rows as v10 does (a [B*nprobe + 1, kk]
    destination), "sorted" (v11b) takes sorted_budget_placement, whose key
    must fit uint32 (budget_sort_key_fits) so that both packages agree on
    where it is taken; its pool columns come in ascending pid order, so
    membership equals scatter's and lane order differs. Inputs and returns
    as grouped_scan_v10."""
    if placement not in BUDGET_PLACEMENTS:
        raise ValueError(f"v10b placement must be 'scatter' or 'sorted', got {placement!r}")
    if pair_budget <= 0:
        raise ValueError(f"v10b needs pair_budget > 0 (got {pair_budget})")
    return _placed_scan("v10b", codes, ids, sizes, norms, q, pids, k, metric, qt, gpb, fold,
                        dedup, pool_factor, bounds, merge, exact, placement,
                        pair_budget=int(pair_budget))
