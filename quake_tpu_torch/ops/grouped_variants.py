"""The four grouped scans with entry points of their own: approx, sized,
packed and multi (their counterparts are quake_tpu/ops/pallas_grouped.py::
grouped_scan_pallas_approx, _sized, _packed and _multi). No dispatch name
reaches them; a caller picks one by calling it.

All four score in f32 with both norms summed in the kernel
(2 <q, x> - |q|^2 - |x|^2 for l2, <q, x> for ip) and differ in the selection:

  approx  kernel K8 `raw_scores` writes every score, [G, qt, C]; the top kk
          of each row are taken outside the kernel (the JAX package: XLA's
          approx_max_k), then `merge_groups`
  sized   kernel `sized_topk`: (score, slot) top-kk over the lanes below the
          partition's size, only the 128-row segments below it read (the
          last one whole, its lanes past the size masked); slot -> id,
          `merge_groups`
  packed  kernel K9 `packed_topk`: top-kk of one int32 per lane that packs a
          monotone key of the score's bit pattern above the lane; unpacked,
          merged per query by the key, and the k winners rescored exactly
  multi   kernel `multi_topk`: (score, slot) top-kk over the lanes with an
          id, ties to the smaller slot; slot -> id, `merge_groups`

The kernels are CUDA (csrc/grouped_variants.cu); each wrapper runs its plain
PyTorch version on CPU tensors and launches the kernel on CUDA tensors. All
four multiply on the tensor cores (split TF32 operands, the body in
csrc/pair_topk_mma.cuh) where D % 4 == 0 and the body's buffers fit
(`raw_scores_body`, `sized_topk_body`, `packed_topk_body`,
`multi_topk_body`), else in f32 on the CUDA cores; K8 and K9 compute their
scores in one order on either body, so K9's output is the top kk of K8's
scores, packed, where both run the same body. On bf16 codes the query
tiles are rounded to bf16, as the JAX wrappers round them, and each kernel
runs its bf16 body (one bf16 product a depth-16 step on the tensor cores
where D % 8 == 0, else the CUDA-core body on values converted to f32 as
they load); both norms come from the rounded tile and the upcast slab, and
packed's exact rescore takes the unrounded query.
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (build_groups, check_operands, launch_name, merge_groups,
                                          operand_bytes, round_query, use_kernel)
from quake_tpu_torch.ops.grouped_family import check_refs, pair_take, topk_cap
from quake_tpu_torch.ops.grouped_scan import FOLD, SMEM_LIMIT
from quake_tpu_torch.ops.scan import NEG_INF, topk_stable
from quake_tpu_torch.profiling import annotate

SELECT_ROWS = 1 << 28  # scores (1 GB of f32) one selection step of the approx scan reads


def _scores(qa, slab, metric: str):
    """[a, qt, D] x [a, C, D] -> [a, qt, C], in the TPU kernels' order; bf16
    operands upcast and multiplied in f32 (a product of two bf16 values is
    exact there)."""
    qa, slab = qa.to(torch.float32), slab.to(torch.float32)
    prod = torch.bmm(qa, slab.transpose(1, 2))
    if metric != "l2":
        return prod
    q_sq = torch.sum(qa * qa, dim=2, keepdim=True)
    s_sq = torch.sum(slab * slab, dim=2)
    return 2.0 * prod - q_sq - s_sq[:, None, :]


def _live_chunks(live, chunk: int):
    """(first group, indices of the live groups) of each chunk that has any."""
    for g0 in range(0, live.shape[0], chunk):
        alive = torch.nonzero(live[g0:g0 + chunk]).flatten()
        if alive.numel():
            yield g0, alive


def _check_smem(name: str, floats: int, what: str) -> None:
    """ValueError where a CUDA-core body needs more shared memory than a
    block has."""
    if floats * 4 > SMEM_LIMIT:
        raise ValueError(f"{name}: {what} need more shared memory than a block has")


def _id_operands(gp, qg, codes, ids):
    """check_operands' table of the kernels that take ids (K8, K9, multi_topk)."""
    (Gn, qt, D), (P, C, _) = qg.shape, codes.shape
    return (("gp", gp, torch.int32, (Gn,)), ("qg", qg, codes.dtype, (Gn, qt, D)),
            ("codes", codes, codes.dtype, (P, C, D)), ("ids", ids, torch.int32, (P, C)))


def _base_floats(qt: int, D: int) -> int:
    """Shared memory (in floats) of the query tile, one segment and its norms."""
    Dp = -(-D // 4) * 4
    return qt * Dp + FOLD * (Dp + 1) + FOLD


# --------------------------------------------------------------- K8, approx


def raw_scores_plain(gp, qg, codes, ids, metric: str, chunk: int = 64):
    """Plain PyTorch version of kernel K8 (same inputs and output as
    raw_scores), `chunk` groups at a time."""
    Gn, qt, _ = qg.shape
    C = codes.shape[1]
    out = torch.full((Gn, qt, C), NEG_INF, device=qg.device, dtype=torch.float32)
    for g0, alive in _live_chunks(gp >= 0, chunk):
        p = gp[g0 + alive].long()
        scores = _scores(qg[g0 + alive], codes[p], metric)
        out[g0 + alive] = torch.where((ids[p] >= 0)[:, None, :], scores,
                                      torch.full_like(scores, NEG_INF))
    return out


MMA_BODY, CUDA_CORE_BODY = 1, 0  # the answers of the *_body functions of this module


def raw_scores_body(qt: int, D: int, dtype=torch.float32) -> int:
    """The body kernel K8's launcher runs at this shape on codes of `dtype`
    (csrc/grouped_variants.cu::pair_body with no list, asked of the built
    library): MMA_BODY, the tensor-core body, where rows are 16-byte aligned
    for the asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and
    its ring and query tile fit a block's shared memory; else
    CUDA_CORE_BODY, one block a group on the CUDA cores."""
    return int(_ext.lib().qk_raw_scores_body(qt, D, operand_bytes(dtype)))


def raw_scores(gp, qg, codes, ids, metric: str):
    """Kernel K8 (replaces pallas_grouped.py::_scores_kernel).

    gp [Gn] int32 partition per group (-1: ghost); qg [Gn, qt, D] queries
    and codes [P, C, D], both f32 or both bf16 (launches of the bf16 body
    count under "raw_scores_bf16"); ids [P, C] int32. Returns scores
    [Gn, qt, C] f32: 2 <q, x> - |q|^2 - |x|^2 (l2, both norms summed here) or
    <q, x> (ip); -inf at lanes with id < 0 and in ghost groups.

    The launcher picks one of two bodies by shape (`raw_scores_body`), never
    after a failure: the tensor-core body (split TF32 product, asynchronous
    copies, persistent blocks, the score tile streamed out; 128-row segments
    whose ids are all < 0 are not loaded and write -inf) or the CUDA-core
    body. Shapes that neither fits raise."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if not use_kernel("raw_scores", qg):
        return raw_scores_plain(gp, qg, codes, ids, metric)
    dtype = codes.dtype
    mma = raw_scores_body(qt, D, dtype) == MMA_BODY
    _check_smem("raw_scores", 0 if mma else _base_floats(qt, D), f"D={D}, qt={qt}")
    check_operands("raw_scores", qg.device, _id_operands(gp, qg, codes, ids), qt, mma)
    out = torch.empty((Gn, qt, C), device=qg.device, dtype=torch.float32)
    _ext.launch(launch_name("raw_scores", dtype), gp, qg, codes, ids, out, Gn, qt, D, P, C,
                int(metric == "l2"), outputs=(out,))
    return out


def select_rows(scores, sids, kk: int):
    """Top kk of every row of scores [G, qt, C] with the ids sids [G, C] of
    its group's lanes, as many groups at a time as hold SELECT_ROWS scores.
    The JAX package selects here with topk_from_scores(approx=True) over a
    [G * qt, C] copy of the ids; this gathers them from a view instead. An
    exact top-k (`torch.topk`, see ops/scan.py::topk_from_scores). Returns
    (scores [G, qt, kk], ids [G, qt, kk]; -inf and -1 = none)."""
    G, qt, C = scores.shape
    step = max(1, SELECT_ROWS // max(qt * C, 1))
    out_s, out_i = [], []
    for g0 in range(0, G, step):
        s, idx = torch.topk(scores[g0:g0 + step], kk, dim=2)
        i = torch.gather(sids[g0:g0 + step, None, :].expand(-1, qt, -1), 2, idx)
        out_s.append(s)
        out_i.append(torch.where(s == NEG_INF, torch.full_like(i, -1), i))
    return torch.cat(out_s), torch.cat(out_i)


def _groups(q, pids, P: int, qt: int, dtype, gb: int = 1):
    """build_groups and the query tiles, rounded to the codes' dtype (dtype),
    the groups padded to a multiple of gb with ghosts (pid -1), as
    grouped_scan_pallas_multi pads them."""
    group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
    pad = -group_pid.shape[0] % gb
    if pad:
        group_pid = torch.nn.functional.pad(group_pid, (0, pad), value=-1)
        qlist = torch.nn.functional.pad(qlist, (0, 0, 0, pad), value=-1)
    qg = round_query(q, dtype)[torch.clamp(qlist, min=0).long()].contiguous()
    return group_pid, qg, pair_group, pair_slot


def grouped_scan_approx(codes, ids, q, pids, k: int, metric: str, qt: int = 64):
    """The approx grouped scan (pallas_grouped.py::grouped_scan_pallas_approx):
    kernel K8 writes the raw scores to device memory and the selection runs
    outside it.

    codes [P, C, D] f32 or bf16, ids [P, C] int32, q [B, D], pids
    [B, nprobe] int32 (-1 = pad). Returns (scores [B, k] f32, ids [B, k]
    int32, scanned [B] int32)."""
    P, C, _ = codes.shape
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, qg, pair_group, pair_slot = _groups(q, pids, P, qt, codes.dtype)
    with annotate("quake.scan"):
        scores = raw_scores(group_pid, qg, codes, ids, metric)
    with annotate("quake.plan.merge"):  # the selection outside the kernel, then the merge
        g_scores, g_ids = select_rows(scores, ids[torch.clamp(group_pid, min=0).long()], kk)
        del scores
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk)


# ------------------------------------------------------------------- sized


def sized_topk_plain(gp, group_size, qg, codes, kk: int, metric: str, ct: int = 256,
                     chunk: int = 256):
    """Plain PyTorch version of kernel sized_topk (same inputs and outputs),
    `chunk` groups at a time, tile by tile and round by round as
    pallas_grouped.py::_sized_kernel: each tile of ct rows is merged with the
    running top-kk in kk joint rounds (a tie goes to the tile; in the tile to
    the larger slot, in the running list to the later entry)."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    dev = qg.device
    out_s = torch.full((Gn, qt, kk), NEG_INF, device=dev, dtype=torch.float32)
    out_i = torch.full((Gn, qt, kk), -1, device=dev, dtype=torch.int32)
    size = torch.where(gp >= 0, torch.clamp(group_size, max=C), torch.zeros_like(group_size))
    n_tiles = (size + ct - 1) // ct
    row_iota = torch.arange(ct, device=dev, dtype=torch.int32)
    lane_k = torch.arange(kk, device=dev, dtype=torch.int32)
    neg = torch.tensor(NEG_INF, device=dev)
    for g0 in range(0, Gn, chunk):
        sl = slice(g0, min(g0 + chunk, Gn))
        for t in range(int(n_tiles[sl].max()) if sl.stop > sl.start else 0):
            act = g0 + torch.nonzero(n_tiles[sl] > t).flatten()
            p = gp[act].long()
            slot_idx = t * ct + row_iota  # global slot of each lane
            # A tile may reach past the slab (ct need not divide C): those rows
            # are clamped for the gather and masked by the size.
            rows = (p * C)[:, None] + torch.clamp(slot_idx, max=C - 1).long()[None, :]
            tile = codes.reshape(P * C, D)[rows]  # [a, ct, D]
            scores_c = _scores(qg[act], tile, metric)
            rem = (size[act] - t * ct)[:, None, None]
            scores_c = torch.where(row_iota[None, None, :] < rem, scores_c, neg)
            carry_s, carry_i = out_s[act], out_i[act]
            new_s, new_i = torch.full_like(carry_s, NEG_INF), torch.full_like(carry_i, -1)
            for i in range(kk):
                tile_best = scores_c.amax(dim=2, keepdim=True)
                carry_best = carry_s.amax(dim=2, keepdim=True)
                take_tile = tile_best >= carry_best
                best = torch.maximum(tile_best, carry_best)
                is_best_t = (scores_c == tile_best) & take_tile
                win_slot_t = torch.where(is_best_t, slot_idx, -1).amax(dim=2, keepdim=True)
                is_best_c = (carry_s == carry_best) & ~take_tile
                win_lane_c = torch.where(is_best_c, lane_k, -1).amax(dim=2, keepdim=True)
                win_idx_c = torch.where(lane_k == win_lane_c, carry_i, -1).amax(dim=2,
                                                                                keepdim=True)
                win = torch.where(take_tile, win_slot_t, win_idx_c)
                win = torch.where(best == NEG_INF, -1, win)
                new_s[:, :, i] = best[:, :, 0]
                new_i[:, :, i] = win[:, :, 0]
                scores_c = torch.where((slot_idx == win_slot_t) & take_tile, neg, scores_c)
                carry_s = torch.where((lane_k == win_lane_c) & ~take_tile, neg, carry_s)
            out_s[act], out_i[act] = new_s, new_i
    return out_s, out_i


def sized_topk_body(qt: int, D: int, kk: int, dtype=torch.float32) -> int:
    """The body kernel sized_topk's launcher runs at this shape on codes of
    `dtype` (csrc/grouped_variants.cu::pair_body, asked of the built
    library): MMA_BODY, the tensor-core body, where rows are 16-byte aligned
    for the asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and
    its ring, query tile and the rows' lists of 3 kk (score, slot) pairs fit
    a block's shared memory; else CUDA_CORE_BODY, one block a group on the
    CUDA cores."""
    return int(_ext.lib().qk_sized_topk_body(qt, D, kk, operand_bytes(dtype)))


def sized_topk(gp, group_size, qg, codes, kk: int, metric: str, ct: int = 256):
    """Kernel sized_topk (replaces pallas_grouped.py::_sized_kernel).

    gp [Gn] int32 partition per group (-1: ghost); group_size [Gn] int32
    valid-prefix length of that partition; qg [Gn, qt, D] and codes
    [P, C, D], both f32 or both bf16 (launches of the bf16 body count under
    "sized_topk_bf16"). Per row the kk best (score, slot) over the lanes below
    the size, scores with both norms summed in the kernel. Returns (scores
    [Gn, qt, kk] f32 descending, -inf = none; slots [Gn, qt, kk] int32,
    -1 = none).

    The launcher picks one of two bodies by shape (`sized_topk_body`), never
    after a failure: the tensor-core body (split TF32 product, asynchronous
    copies, persistent blocks) loads the ceil(size / 128) segments that hold
    a partition's vectors, the last one whole, and masks its lanes at or
    past the size (the TPU kernel also copies whole ct-row tiles); the
    CUDA-core body (round_up(kk, 32) + 128 candidates a row) reads no row at
    or past the size. What those rows hold reaches no output. Shapes that
    neither fits raise.

    ct is the TPU kernel's tile height, which the result does not depend on
    (except for the order among equal scores): the plain version merges tile
    by tile as that kernel does; the CUDA kernel streams 128-row segments
    whatever ct is and orders equal scores by the larger slot."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if ct <= 0:
        raise ValueError(f"sized_topk: ct must be positive (ct={ct})")
    if not use_kernel("sized_topk", qg):
        return sized_topk_plain(gp, group_size, qg, codes, kk, metric, ct)
    dtype = codes.dtype
    mma = sized_topk_body(qt, D, kk, dtype) == MMA_BODY
    _check_smem("sized_topk", 0 if mma else _base_floats(qt, D) + 2 * qt * topk_cap(kk),
                f"D={D}, qt={qt}, kk={kk} (round_up(kk, 32) + 128 (score, slot) pairs per row)")
    check_operands("sized_topk", qg.device, (
        ("gp", gp, torch.int32, (Gn,)), ("group_size", group_size, torch.int32, (Gn,)),
        ("qg", qg, dtype, (Gn, qt, D)), ("codes", codes, dtype, (P, C, D))), qt, mma)
    out_s = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    out_i = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.int32)
    _ext.launch(launch_name("sized_topk", dtype), gp, group_size, qg, codes, out_s, out_i,
                Gn, qt, D, P, C, kk, int(metric == "l2"), outputs=(out_s,))
    return out_s, out_i


def _slots_to_ids(ids, group_pid, g_scores, g_slots, C: int):
    """Vector ids of (group, slot) winners; -1 where there is none (a slot
    outside [0, C), a score of -inf) or the slot holds no vector."""
    safe_pid = torch.clamp(group_pid, min=0).long()[:, None, None]
    g_ids = ids.reshape(-1)[safe_pid * C + torch.clamp(g_slots, 0, C - 1).long()]
    valid = (g_slots >= 0) & (g_slots < C) & (g_ids >= 0) & (g_scores != NEG_INF)
    return (torch.where(valid, g_scores, torch.full_like(g_scores, NEG_INF)),
            torch.where(valid, g_ids, torch.full_like(g_ids, -1)))


def grouped_scan_sized(codes, ids, sizes, q, pids, k: int, metric: str, qt: int = 32,
                       ct: int = 256):
    """The size-aware grouped scan (pallas_grouped.py::
    grouped_scan_pallas_sized): kernel sized_topk reads only the 128-row
    segments that hold each probed partition's valid prefix. sizes [P]
    int32; the store must keep its vectors in a compact prefix (slots below
    sizes[p]). Same other inputs and returns as grouped_scan_approx."""
    P, C, _ = codes.shape
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, qg, pair_group, pair_slot = _groups(q, pids, P, qt, codes.dtype)
        group_size = torch.where(group_pid >= 0, sizes[torch.clamp(group_pid, min=0).long()],
                                 torch.zeros_like(group_pid)).to(torch.int32).contiguous()
    with annotate("quake.scan"):
        g_scores, g_slots = sized_topk(group_pid, group_size, qg, codes, kk, metric, ct)
    with annotate("quake.plan.merge"):
        g_scores, g_ids = _slots_to_ids(ids, group_pid, g_scores, g_slots, C)
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk)


# -------------------------------------------------------------- K9, packed


def slot_bits_of(C: int) -> int:
    """Bits of the lane in K9's packed value."""
    return max(int(C - 1).bit_length(), 1)


def pack_scores(scores, slot_bits: int):
    """scores [..., C] f32 -> packed int32 of every lane: a monotone map of
    the f32 bit pattern onto uint32 (negative: all bits flipped; else the
    sign bit set), its top 31 - slot_bits bits, above the lane. The uint32
    arithmetic runs in int64."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >> 31 == 1, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    lane = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    return (((key >> (slot_bits + 1)) << slot_bits) | lane).to(torch.int32)


def packed_topk_plain(gp, qg, codes, ids, kk: int, metric: str, chunk: int = 256):
    """Plain PyTorch version of kernel K9 (same inputs and output as
    packed_topk), `chunk` groups at a time. Packed values of valid lanes are
    distinct, so pallas_grouped.py::_packed_kernel's kk rounds of
    max-and-clear are a descending top-kk."""
    Gn, qt, _ = qg.shape
    C = codes.shape[1]
    out = torch.full((Gn, qt, kk), -1, device=qg.device, dtype=torch.int32)
    for g0, alive in _live_chunks(gp >= 0, chunk):
        p = gp[g0 + alive].long()
        packed = pack_scores(_scores(qg[g0 + alive], codes[p], metric), slot_bits_of(C))
        packed = torch.where((ids[p] >= 0)[:, None, :], packed, torch.full_like(packed, -1))
        out[g0 + alive] = torch.topk(packed, kk, dim=2).values
    return out


def packed_topk_body(qt: int, D: int, kk: int, dtype=torch.float32) -> int:
    """The body kernel K9's launcher runs at this shape on codes of `dtype`
    (csrc/grouped_variants.cu::pair_body, asked of the built library):
    MMA_BODY, the tensor-core body, where D % 4 == 0 (f32) or D % 8 == 0
    (bf16) and its ring, query tile and the rows' lists of 3 kk (0, packed
    value) pairs fit a block's shared memory; else CUDA_CORE_BODY, one block
    a group on the CUDA cores."""
    return int(_ext.lib().qk_packed_topk_body(qt, D, kk, operand_bytes(dtype)))


def _packed_floats(qt: int, D: int, kk: int) -> int:
    """Shared memory (in floats) of K9's CUDA-core body: the query tile, a
    segment and round_up(kk, 32) + 128 packed values a row."""
    return _base_floats(qt, D) + qt * topk_cap(kk)


def packed_topk_serves(qt: int, D: int, kk: int, dtype=torch.float32) -> bool:
    """Whether K9 serves (qt, D, kk) on the card on codes of `dtype`: its
    tensor-core body takes the shape, or its CUDA-core body's buffers fit a
    block's shared memory."""
    return (packed_topk_body(qt, D, kk, dtype) == MMA_BODY
            or _packed_floats(qt, D, kk) * 4 <= SMEM_LIMIT)


def packed_topk(gp, qg, codes, ids, kk: int, metric: str):
    """Kernel K9 (replaces pallas_grouped.py::_packed_kernel).

    gp [Gn] int32 (-1: ghost); qg [Gn, qt, D] and codes [P, C, D], both f32
    or both bf16 (launches of the bf16 body count under "packed_topk_bf16");
    ids [P, C] int32. Per row the kk largest packed values (see pack_scores) of
    the lanes with id >= 0, descending; -1 = none, and all -1 in ghost
    groups. Returns [Gn, qt, kk] int32.

    The launcher picks one of two bodies by shape (`packed_topk_body`), never
    after a failure: the tensor-core body, K8's with a selection on the pair
    (0, packed value), or the CUDA-core body (round_up(kk, 32) + 128
    candidates a row). Shapes that neither fits raise."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if not use_kernel("packed_topk", qg):
        return packed_topk_plain(gp, qg, codes, ids, kk, metric)
    dtype = codes.dtype
    mma = packed_topk_body(qt, D, kk, dtype) == MMA_BODY
    _check_smem("packed_topk", 0 if mma else _packed_floats(qt, D, kk),
                f"D={D}, qt={qt}, kk={kk} (round_up(kk, 32) + 128 candidates per row)")
    check_operands("packed_topk", qg.device, _id_operands(gp, qg, codes, ids), qt, mma)
    out = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.int32)
    _ext.launch(launch_name("packed_topk", dtype), gp, qg, codes, ids, out, Gn, qt, D, P, C, kk,
                int(metric == "l2"), slot_bits_of(C))
    return out


def grouped_scan_packed(codes, ids, q, pids, k: int, metric: str, qt: int = 32):
    """The packed-selection grouped scan (pallas_grouped.py::
    grouped_scan_pallas_packed): kernel K9, a per-query merge by the
    quantized key and an exact rescore of the winners, so the scores
    returned are exact and only the order of near-ties at the selection is
    not. Same inputs as grouped_scan_approx; returns (scores, ids, scanned)
    of width min(k, nprobe * min(k, C)), as the JAX function does."""
    B = q.shape[0]
    P, C, _ = codes.shape
    check_refs("packed", P, C)
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, qg, pair_group, pair_slot = _groups(q, pids, P, qt, codes.dtype)
    with annotate("quake.scan"):
        g_packed = packed_topk(group_pid, qg, codes, ids, kk, metric)

    with annotate("quake.plan.merge"):
        # Unpack: the slot and the quantized rank key (as f32, as the JAX package).
        slot_bits = slot_bits_of(C)
        slots = torch.clamp(g_packed & ((1 << slot_bits) - 1), max=C - 1)
        keys = (g_packed >> slot_bits).to(torch.float32)
        gpid = torch.clamp(group_pid, min=0)[:, None, None]
        cand_ids = ids.reshape(-1)[gpid.long() * C + slots.long()]
        valid = (g_packed >= 0) & (cand_ids >= 0)
        keys = torch.where(valid, keys, torch.full_like(keys, -1.0))
        cand_ids = torch.where(valid, cand_ids, torch.full_like(cand_ids, -1))
        refs = (gpid << 16) | slots  # (pid, slot), for the exact rescore

        ok = (pair_group >= 0)[:, :, None]
        pg = torch.clamp(pair_group, min=0)
        m_keys = torch.where(ok, pair_take(keys, pg, pair_slot), -1.0).reshape(B, -1)
        m_ids = torch.where(ok, pair_take(cand_ids, pg, pair_slot), -1).reshape(B, -1)
        m_refs = torch.where(ok, pair_take(refs, pg, pair_slot), -1).reshape(B, -1)
        kfin = min(k, m_keys.shape[1])
        _, idx = topk_stable(m_keys, kfin)
        top_ids = torch.gather(m_ids, 1, idx)
        top_refs = torch.gather(m_refs, 1, idx)

    with annotate("quake.plan.rescore"):
        # Exact rescore of the winners (exact distances and order).
        w_pid = torch.clamp(top_refs >> 16, min=0).long()
        w_slot = torch.clamp(top_refs & 0xFFFF, max=C - 1).long()
        vecs = codes.reshape(P * C, -1)[w_pid * C + w_slot].to(torch.float32)  # [B, kfin, D]
        qf = q.to(torch.float32)
        prod = torch.einsum("bkd,bd->bk", vecs, qf)
        if metric == "l2":
            exact = (2.0 * prod - torch.sum(qf * qf, dim=1, keepdim=True)
                     - torch.sum(vecs * vecs, dim=2))
        else:
            exact = prod
        exact = torch.where(top_ids >= 0, exact, torch.full_like(exact, NEG_INF))
        scores, order = topk_stable(exact, kfin)
        out_ids = torch.gather(top_ids, 1, order)
        out_ids = torch.where(torch.isfinite(scores), out_ids, torch.full_like(out_ids, -1))
        scores = torch.where(out_ids >= 0, scores, torch.full_like(scores, NEG_INF))
        scanned = torch.sum((pids >= 0).to(torch.int32), dim=1, dtype=torch.int32)
    return scores, out_ids.to(torch.int32), scanned


# ------------------------------------------------------------------- multi


def multi_topk_plain(gp, qg, codes, ids, kk: int, metric: str, chunk: int = 256):
    """Plain PyTorch version of kernel multi_topk (same inputs and outputs),
    `chunk` groups at a time, round by round as pallas_grouped.py::
    _multi_kernel: kk rounds of (max score, leftmost slot among ties)."""
    Gn, qt, _ = qg.shape
    C = codes.shape[1]
    dev = qg.device
    out_s = torch.full((Gn, qt, kk), NEG_INF, device=dev, dtype=torch.float32)
    out_i = torch.full((Gn, qt, kk), C, device=dev, dtype=torch.int32)
    lane = torch.arange(C, device=dev, dtype=torch.int32)
    neg = torch.tensor(NEG_INF, device=dev)
    for g0, alive in _live_chunks(gp >= 0, chunk):
        p = gp[g0 + alive].long()
        scores = torch.where((ids[p] >= 0)[:, None, :], _scores(qg[g0 + alive], codes[p], metric),
                             neg)
        for i in range(kk):
            best = scores.amax(dim=2, keepdim=True)
            first = torch.where(scores == best, lane, C).amin(dim=2, keepdim=True)
            out_s[g0 + alive, :, i] = best[:, :, 0]
            # Past a row's valid lanes the TPU kernel leaves the leftmost
            # cleared lane here; the empty sentinel C is this package's contract.
            out_i[g0 + alive, :, i] = torch.where(best == NEG_INF, C, first)[:, :, 0]
            scores = torch.where(lane == first, neg, scores)
    return out_s, out_i


def multi_topk_body(qt: int, D: int, kk: int, dtype=torch.float32) -> int:
    """The body kernel multi_topk's launcher runs at this shape on codes of
    `dtype` (csrc/grouped_variants.cu::pair_body, asked of the built
    library): MMA_BODY, the tensor-core body, where rows are 16-byte aligned
    for the asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and
    its ring, query tile and the rows' lists of 3 kk (score, slot) pairs fit
    a block's shared memory; else CUDA_CORE_BODY, gb groups a block on the
    CUDA cores."""
    return int(_ext.lib().qk_multi_topk_body(qt, D, kk, operand_bytes(dtype)))


def _multi_floats(qt: int, D: int, kk: int) -> int:
    """Shared memory (in floats) of multi_topk's CUDA-core body: the query
    tile, a segment and round_up(kk, 32) + 128 (score, slot) pairs a row."""
    return _base_floats(qt, D) + 2 * qt * topk_cap(kk)


def multi_topk_serves(qt: int, D: int, kk: int, dtype=torch.float32) -> bool:
    """Whether multi_topk serves (qt, D, kk) on the card on codes of `dtype`:
    its tensor-core body takes the shape, or its CUDA-core body's buffers fit
    a block's shared memory."""
    return (multi_topk_body(qt, D, kk, dtype) == MMA_BODY
            or _multi_floats(qt, D, kk) * 4 <= SMEM_LIMIT)


def multi_topk(gp, qg, codes, ids, kk: int, metric: str, gb: int = 8):
    """Kernel multi_topk (replaces pallas_grouped.py::_multi_kernel).

    gp [Gn] int32 (-1: ghost), Gn a multiple of gb; qg [Gn, qt, D] and codes
    [P, C, D], both f32 or both bf16 (launches of the bf16 body count under
    "multi_topk_bf16"); ids [P, C] int32. Per row the kk best (score, slot) over
    the lanes with id >= 0 of the whole slab, scores with both norms summed
    in the kernel, ties to the smaller slot. Returns (scores [Gn, qt, kk] f32
    descending, -inf = none; slots [Gn, qt, kk] int32, C = none).

    The launcher picks one of two bodies by shape (`multi_topk_body`), never
    after a failure: the tensor-core body (split TF32 product, asynchronous
    copies, persistent blocks; 128-row segments whose ids are all < 0 are
    neither loaded nor multiplied; gb only pads the groups) or, for
    D % 4 != 0 and where its lists crowd out the ring, the CUDA-core body,
    one block for every gb consecutive groups. Shapes past
    `multi_topk_serves` raise."""
    Gn, qt, D = qg.shape
    P, C, _ = codes.shape
    if gb <= 0 or Gn % gb:
        raise ValueError(f"multi_topk: the group count must be a multiple of gb "
                         f"(Gn={Gn}, gb={gb})")
    if not use_kernel("multi_topk", qg):
        return multi_topk_plain(gp, qg, codes, ids, kk, metric)
    dtype = codes.dtype
    mma = multi_topk_body(qt, D, kk, dtype) == MMA_BODY
    _check_smem("multi_topk", 0 if mma else _multi_floats(qt, D, kk),
                f"D={D}, qt={qt}, kk={kk} (round_up(kk, 32) + 128 (score, slot) pairs per row)")
    check_operands("multi_topk", qg.device, _id_operands(gp, qg, codes, ids), qt, mma)
    out_s = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)
    out_i = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.int32)
    _ext.launch(launch_name("multi_topk", dtype), gp, qg, codes, ids, out_s, out_i,
                Gn, qt, D, P, C, kk, int(metric == "l2"), gb, outputs=(out_s,))
    return out_s, out_i


def grouped_scan_multi(codes, ids, q, pids, k: int, metric: str, qt: int = 32, gb: int = 8):
    """The multi-group grouped scan (pallas_grouped.py::
    grouped_scan_pallas_multi): the groups padded to a multiple of gb with
    ghosts, kernel multi_topk, slot -> id (slots
    without a vector dropped), `merge_groups`. Same inputs and returns as
    grouped_scan_approx."""
    P, C, _ = codes.shape
    kk = min(k, C)
    with annotate("quake.plan.grouping"):
        group_pid, qg, pair_group, pair_slot = _groups(q, pids, P, qt, codes.dtype, gb)
    with annotate("quake.scan"):
        g_scores, g_slots = multi_topk(group_pid, qg, codes, ids, kk, metric, gb)
    with annotate("quake.plan.merge"):
        g_scores, g_ids = _slots_to_ids(ids, group_pid, g_scores, g_slots, C)
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk)
