"""Partition-major grouping for the batched search (group_layout,
build_groups, build_groups_scatter, budget_layout, build_groups_budget and
build_chunk_groups of
quake_tpu/ops/grouped.py) and the scan that runs outside any hand-written
kernel (grouped_scan_xla with its merge_groups epilogue, which the exact
v2/v3 scans share).

The reference's batched_serial_scan groups queries by partition on the host
so each partition is scanned once per batch (query_coordinator.cpp:708-721).
Here the inversion runs on the device: pids [B, nprobe] become fixed-size
groups, each one partition and up to QT probing queries. Pure integer
arithmetic, so the outputs equal the JAX package's exactly.
"""

from __future__ import annotations

import torch

from quake_tpu_torch.ops.scan import NEG_INF, duplicate_mask, topk_from_scores, topk_stable
from quake_tpu_torch.profiling import annotate


def group_layout(B: int, nprobe: int, nlist_cap: int, qt: int) -> int:
    """Worst-case number of groups: every probed partition needs
    ceil(count/QT) groups; counts sum to B*nprobe and there are at most
    min(B*nprobe, nlist_cap) distinct partitions."""
    n_pairs = B * nprobe
    max_unique = min(n_pairs, nlist_cap)
    return max_unique + n_pairs // qt


def budget_layout(n_bud: int, nlist_cap: int, qt: int) -> int:
    """Worst-case group count of a pair-budgeted grouping: at most
    min(n_bud, nlist_cap) distinct partitions, each adding one partial
    group on top of the n_bud // qt full ones (see group_layout)."""
    return min(n_bud, nlist_cap) + n_bud // qt


def _sorted_groups(pids: torch.Tensor, nlist_cap: int, qt: int, n_bud: int = 0):
    """Shared prologue of build_groups, build_groups_scatter and
    build_groups_budget.

    One sort of the unique key (pid+1)*n + flat_index orders the pairs by
    (partition, flat index) — the stable order; int64 keys never overflow,
    so the JAX package's argsort branch for huge shapes is not needed. Pairs
    whose pid is -1 key below partition 0 and stay out of every run; with
    n_bud > 0 they key past the last partition instead, and the sorted order
    is cut at n_bud pairs (the caller guarantees that no more are valid), so
    the groups are sized to the budget. Run offsets come from a left-side
    searchsorted; each populated partition stamps p+1 at its first group
    (scatter-max) and a running max fills its groups. Returns (group_pid [G]
    int64, order [n or n_bud] sorted position -> flat pair index, offs [P+1]
    run offsets, gbase [P] first group of each partition, tgt_raw [G, qt]
    flat pair index of each kernel row, valid [G, qt] whether that row holds
    a pair)."""
    B, nprobe = pids.shape
    n = B * nprobe
    P = nlist_cap
    dev = pids.device
    flat_pid = pids.reshape(-1).to(torch.int64)
    iota_n = torch.arange(n, device=dev, dtype=torch.int64)

    if n_bud > 0:
        G = budget_layout(n_bud, P, qt)
        keys = torch.where(flat_pid >= 0, (flat_pid + 1) * n + iota_n, (P + 1) * n + iota_n)
        key_sorted = torch.sort(keys).values[:n_bud]
    else:
        G = group_layout(B, nprobe, P, qt)
        key_sorted = torch.sort((flat_pid + 1) * n + iota_n).values
    order = key_sorted - (key_sorted // n) * n
    bounds = (torch.arange(P + 1, device=dev, dtype=torch.int64) + 1) * n
    offs = torch.searchsorted(key_sorted, bounds)  # side="left"

    counts = offs[1:] - offs[:-1]
    groups_of = (counts + qt - 1) // qt
    gbase = torch.cumsum(groups_of, 0) - groups_of
    total_groups = gbase[-1] + groups_of[-1]

    g_iota = torch.arange(G, device=dev, dtype=torch.int64)
    p_iota = torch.arange(P, device=dev, dtype=torch.int64)
    marks = torch.zeros(G + 1, device=dev, dtype=torch.int64)
    stamp_at = torch.where(groups_of > 0, torch.clamp(gbase, max=G), torch.full_like(gbase, G))
    marks = marks.scatter_reduce(0, stamp_at, p_iota + 1, reduce="amax")
    p_of_g = torch.cummax(marks[:G], 0).values - 1
    p_of_g = torch.clamp(p_of_g, 0, P - 1)
    g_valid = g_iota < total_groups
    group_pid = torch.where(g_valid, p_of_g, torch.full_like(p_of_g, -1))
    tile = g_iota - gbase[p_of_g]
    start = offs[p_of_g] + tile * qt
    lane = torch.arange(qt, device=dev, dtype=torch.int64)
    pos = start[:, None] + lane[None, :]
    in_run = pos < (offs[p_of_g] + counts[p_of_g])[:, None]
    tgt_raw = order[torch.clamp(pos, 0, order.numel() - 1)]
    valid = g_valid[:, None] & in_run
    return group_pid, order, offs, gbase, tgt_raw, valid


def _scatter_tables(pids: torch.Tensor, nlist_cap: int, qt: int, n_bud: int = 0):
    B, nprobe = pids.shape
    n = B * nprobe
    group_pid, _, _, _, tgt_raw, valid = _sorted_groups(pids, nlist_cap, qt, n_bud)
    qlist = torch.where(valid, tgt_raw // nprobe, torch.full_like(tgt_raw, -1))
    tgt = torch.where(valid, tgt_raw, torch.full_like(tgt_raw, n))
    return (group_pid.to(torch.int32), qlist.to(torch.int32),
            tgt.to(torch.int32))


def build_groups_scatter(pids: torch.Tensor, nlist_cap: int, qt: int):
    """Invert per-query probe lists into partition-major groups (the v11
    layout).

    pids: [B, nprobe] int (-1 = pad). Returns int32 tensors:
      group_pid [G]      partition of each group (-1 = unused)
      qlist     [G, QT]  query indices per group (-1 = pad)
      tgt       [G, QT]  flat pair index (b*nprobe + j) of each kernel row;
                         n = B*nprobe for invalid rows
    """
    return _scatter_tables(pids, nlist_cap, qt)


def build_groups_budget(pids: torch.Tensor, nlist_cap: int, qt: int, n_bud: int):
    """build_groups_scatter with the tables sized to a PAIR BUDGET
    (quake_tpu/ops/grouped.py::build_groups_budget): invalid pairs sort
    last and the sorted order is cut at min(n_bud, B*nprobe) pairs, so the
    group tables, and the kernel grid and placement sized from them, scale
    with the budget instead of B*nprobe. The caller guarantees that at most
    n_bud pairs are valid (aps_oneshot's and aps_plan's plan clipping);
    valid pairs past the budget would be dropped.

    Returns (group_pid [Gb], qlist [Gb, QT], tgt [Gb, QT]) int32 with Gb =
    budget_layout(n_bud, nlist_cap, qt); tgt is the flat pair index b *
    nprobe + j of each kernel row (B*nprobe for the rows of no pair), as
    build_groups_scatter returns. The keys are int64 where the JAX package
    packs int32 below (P + 2) n < 2^31 and sorts two operands above it: the
    order is the same."""
    B, nprobe = pids.shape
    return _scatter_tables(pids, nlist_cap, qt, min(int(n_bud), B * nprobe))


def build_groups(pids: torch.Tensor, nlist_cap: int, qt: int):
    """Invert per-query probe lists into partition-major groups, with the
    pair-major inverse (quake_tpu/ops/grouped.py::build_groups, the layout
    of the v3p/v7/v8/v9 scans).

    pids: [B, nprobe] int (-1 = pad). Returns int32 tensors:
      group_pid  [G]          partition of each group (-1 = unused)
      qlist      [G, QT]      query indices per group (-1 = pad)
      pair_group [B, nprobe]  group of each (query, probe) pair (-1 = pad)
      pair_slot  [B, nprobe]  row of the pair within its group (0 = pad)

    The groups equal build_groups_scatter's; a pair's rank inside its
    partition's run is its sorted position (the inverse permutation of the
    sort) minus the run offset.
    """
    B, nprobe = pids.shape
    P = nlist_cap
    group_pid, order, offs, gbase, tgt_raw, valid = _sorted_groups(pids, P, qt)
    qlist = torch.where(valid, tgt_raw // nprobe, torch.full_like(tgt_raw, -1))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device, dtype=order.dtype)
    safe = torch.clamp(pids.to(torch.int64), 0, P - 1)
    rank = inv.reshape(B, nprobe) - offs[safe]
    ok = pids >= 0
    pair_group = torch.where(ok, gbase[safe] + rank // qt, torch.full_like(rank, -1))
    pair_slot = torch.where(ok, rank % qt, torch.zeros_like(rank))
    return (group_pid.to(torch.int32), qlist.to(torch.int32),
            pair_group.to(torch.int32), pair_slot.to(torch.int32))


def build_chunk_groups(pids: torch.Tensor, sizes: torch.Tensor, nlist_cap: int, qt: int,
                       ct: int, cap: int):
    """Chunk-level grouping for the size-aware v4 scan
    (quake_tpu/ops/grouped.py::build_chunk_groups).

    Each (partition, query-tile) group of build_groups expands into
    ceil(size/ct) chunk-groups covering only the partition's valid prefix;
    the chunk-groups are a compact prefix of [0, G * ceil(cap/ct)). Returns
    int32 tensors:
      cg_pid    [G2]  partition of each chunk-group (-1 = unused)
      cg_chunk  [G2]  chunk index within the partition (units of ct)
      cg_qsrc   [G2]  source group (row into qlist)
      cg_size   [G2]  valid lanes in this chunk (0 = skip)
      qlist     [G, QT]
      pair_cg   [B, nprobe, MAXCH]  chunk-groups of each pair (-1 = pad)
      pair_slot [B, nprobe]
    """
    group_pid, qlist, pair_group, pair_slot = build_groups(pids, nlist_cap, qt)
    G = group_pid.shape[0]
    maxch = -(-cap // ct)
    G2 = G * maxch
    dev = pids.device
    gsz = torch.where(group_pid >= 0, sizes[torch.clamp(group_pid, min=0).long()].to(torch.int32),
                      torch.zeros_like(group_pid))
    nch = (gsz + ct - 1) // ct  # chunks this group needs
    base = (torch.cumsum(nch, 0) - nch).to(torch.int32)
    ch = torch.arange(maxch, device=dev, dtype=torch.int32)
    used = ch[None, :] < nch[:, None]
    # Unused (group, chunk) cells aim at row G2, which the slice drops (the
    # JAX package scatters with mode="drop").
    tgt = torch.where(used, base[:, None] + ch[None, :], G2).reshape(-1).long()

    def scatter(fill: int, values):
        out = torch.full((G2 + 1,), fill, device=dev, dtype=torch.int32)
        out[tgt] = values.expand(G, maxch).reshape(-1).to(torch.int32)
        return out[:G2]

    cg_pid = scatter(-1, group_pid[:, None])
    cg_chunk = scatter(0, ch[None, :])
    cg_qsrc = scatter(0, torch.arange(G, device=dev, dtype=torch.int32)[:, None])
    cg_size = scatter(0, torch.clamp(gsz[:, None] - ch[None, :] * ct, 0, ct))

    ok = pair_group >= 0
    pg = torch.clamp(pair_group, min=0).long()
    pair_cg = base[pg][:, :, None] + ch[None, None, :]
    pair_cg = torch.where(ok[:, :, None] & (ch[None, None, :] < nch[pg][:, :, None]),
                          pair_cg, torch.full_like(pair_cg, -1))
    return cg_pid, cg_chunk, cg_qsrc, cg_size, qlist, pair_cg.to(torch.int32), pair_slot


def group_scores(qg, slab, sids, metric: str, snorms=None):
    """qg [Gc, QT, D], slab [Gc, C, D], sids [Gc, C] -> scores [Gc, QT, C]
    (quake_tpu/ops/grouped.py::_group_scores). snorms: optional [Gc, C]
    cached squared norms of the slab; -inf where sids < 0. bf16 operands
    (the query tiles already rounded to bf16) are multiplied in f32: a
    product of two bf16 values is exact there, as in the JAX package's
    f32-accumulating dot."""
    qf, sf = qg.to(torch.float32), slab.to(torch.float32)
    prod = torch.bmm(qf, sf.transpose(1, 2))
    if metric == "l2":
        q_sq = torch.sum(qf * qf, dim=2)
        if snorms is None:
            snorms = torch.sum(sf * sf, dim=2)
        scores = 2.0 * prod - q_sq[:, :, None] - snorms[:, None, :]
    else:
        scores = prod
    return torch.where((sids >= 0)[:, None, :], scores, torch.full_like(scores, NEG_INF))


OPERAND_DTYPES = (torch.float32, torch.bfloat16)  # the codes' dtypes every scan kernel takes


def round_query(q, dtype):
    """The queries as the JAX wrappers of K3-K9, sized_topk and multi_topk
    hand them to their kernels: q itself rounded to the codes' dtype
    (`q.astype(codes.dtype)`, quake_tpu/ops/pallas_grouped.py and
    pallas_flat.py). K1's family (v8-v11, v10b) rounds q * q_coef instead
    (grouped_scan.global_scale); the epilogues that subtract |q|^2 take the
    unrounded f32 query."""
    return q.to(dtype)


def operand_bytes(dtype) -> int:
    """Bytes an element of a kernel's query tile and codes: the *_body
    queries' elem_bytes, 2 for bf16 and 4 for f32."""
    if dtype not in OPERAND_DTYPES:
        raise ValueError(f"scan kernels take float32 or bfloat16 codes, not {dtype}")
    return 2 if dtype == torch.bfloat16 else 4


def launch_name(kernel: str, dtype) -> str:
    """The launch count a kernel's launch goes to, and its launcher's name
    without qk_ (_ext.launch): bf16 launches run their own launcher and
    count under their own name (`kernel`_bf16), as K1's grouped_scan_bf16
    does."""
    operand_bytes(dtype)
    return f"{kernel}_bf16" if dtype == torch.bfloat16 else kernel


QTS = (64, 32, 16, 8)  # query-tile heights the kernels are built for
# Operands whose start the tensor-core bodies' copies align: the query tiles
# and codes to 16 bytes, the f32 norm and bias rows (read in pairs) to 8.
ALIGN = {"qg": 16, "codes": 16, "q": 16, "codes2d": 16, "normsT": 8, "bias": 8}


def use_kernel(name: str, t) -> bool:
    """Whether a kernel's wrapper launches it on t's device (cuda) or runs
    its plain version (cpu); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check_operands(name: str, device, operands, qt: int | None = None,
                   mma: bool = False) -> None:
    """The tensor contract of a kernel's launch: each (name, tensor, dtype,
    shape) of `operands` a contiguous tensor of that dtype and shape on
    `device`, qt (for the kernels that take a query tile) one of QTS, and
    where the tensor-core body runs (mma) the operands that ALIGN names on
    its boundaries. ValueError names the first breach."""
    if qt is not None and qt not in QTS:
        raise ValueError(f"{name}: qt must be 8, 16, 32 or 64 (qt={qt})")
    for tname, t, dtype, shape in operands:
        if (t is None or t.device != device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be a contiguous {dtype} {shape} tensor on "
                             f"{device}")
        if mma and t.data_ptr() % ALIGN.get(tname, 1):
            raise ValueError(f"{name}: {tname} must start on a {ALIGN[tname]}-byte boundary")


def merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k: int, kk: int,
                 dedup: bool = False):
    """Epilogue of the (score, id) scans (quake_tpu/ops/grouped.py::
    _merge_groups): gather each query's per-probe group rows and merge them
    to the top k, padding with -inf / -1 when there are fewer than k
    candidates. dedup (a spilled store, each vector in two partitions): the
    top min(2k, pool), each id kept at its first occurrence, the top k of
    the survivors. Returns (scores [B, k] f32, ids [B, k] int32, scanned
    [B] int32)."""
    B, nprobe = pair_group.shape
    ok = (pair_group >= 0)[:, :, None]
    G, qt, kk_ = g_scores.shape
    flat_idx = torch.clamp(pair_group, min=0).long() * qt + pair_slot.long()
    s = g_scores.reshape(G * qt, kk_)[flat_idx]
    i = g_ids.reshape(G * qt, kk_)[flat_idx]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    i = torch.where(ok, i, torch.full_like(i, -1))
    pool = min(2 * k if dedup else k, nprobe * kk)
    scores, out_ids = topk_from_scores(s.reshape(B, nprobe * kk), i.reshape(B, nprobe * kk),
                                       pool)
    if dedup:
        is_dup = duplicate_mask(out_ids)
        scores = torch.where(is_dup, torch.full_like(scores, NEG_INF), scores)
        out_ids = torch.where(is_dup, torch.full_like(out_ids, -1), out_ids)
        scores, order = topk_stable(scores, pool)
        out_ids = torch.gather(out_ids, 1, order)
    scores, out_ids = scores[:, :k], out_ids[:, :k]
    if scores.shape[1] < k:
        padn = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, padn), value=NEG_INF)
        out_ids = torch.nn.functional.pad(out_ids, (0, padn), value=-1)
    scanned = torch.sum((pids >= 0).to(torch.int32), dim=1, dtype=torch.int32)
    return scores, out_ids.to(torch.int32), scanned


def grouped_scan_xla(codes, ids, q, pids, k: int, metric: str, qt: int = 64,
                     group_chunk: int = 64, norms=None, dedup: bool = False):
    """Partition-major batched scan in plain tensor operations
    (quake_tpu/ops/grouped.py::grouped_scan_xla, the JAX package's scan on
    every backend that is not a TPU): `group_chunk` groups at a time, a
    batched product of the query tiles with the gathered slabs and an exact
    top-kk per row (the JAX package's approx_max_k is exact on the CPU), then
    merge_groups. No hand-written kernel is on this path, in either package.

    codes [P, C, D], ids [P, C], q [B, D], pids [B, nprobe] int32; norms:
    optional [P, C] cached squared norms. Returns (scores [B, k], ids [B, k],
    scanned [B]). dedup: merge_groups' dedup (a spilled store)."""
    P, C, _ = codes.shape
    with annotate("quake.plan.grouping"):
        group_pid, qlist, pair_group, pair_slot = build_groups(pids, P, qt)
        G = group_pid.shape[0]
        kk = min(k, C)
        q_cast = q.to(codes.dtype)
    with annotate("quake.scan"):
        out_s, out_i = [], []
        for g0 in range(0, G, group_chunk):
            gpid = group_pid[g0:g0 + group_chunk]
            safe_pid = torch.clamp(gpid, min=0).long()
            sids = torch.where((gpid >= 0)[:, None], ids[safe_pid],
                               torch.full_like(ids[safe_pid], -1))
            qg = q_cast[torch.clamp(qlist[g0:g0 + group_chunk], min=0).long()]
            scores = group_scores(qg, codes[safe_pid], sids, metric,
                                  norms[safe_pid] if norms is not None else None)
            s, idx = torch.topk(scores, kk, dim=2)
            i = torch.gather(sids[:, None, :].expand(-1, qt, -1), 2, idx)
            out_s.append(s)
            out_i.append(torch.where(s == NEG_INF, torch.full_like(i, -1), i))
        g_scores, g_ids = torch.cat(out_s), torch.cat(out_i)
    with annotate("quake.plan.merge"):
        return merge_groups(g_scores, g_ids, pair_group, pair_slot, pids, k, kk, dedup=dedup)
