"""Partition-major grouping for the batched search (group_layout,
build_groups and build_groups_scatter of quake_tpu/ops/grouped.py).

The reference's batched_serial_scan groups queries by partition on the host
so each partition is scanned once per batch (query_coordinator.cpp:708-721).
Here the inversion runs on the device: pids [B, nprobe] become fixed-size
groups, each one partition and up to QT probing queries. Pure integer
arithmetic, so the outputs equal the JAX package's exactly.
"""

from __future__ import annotations

import torch


def group_layout(B: int, nprobe: int, nlist_cap: int, qt: int) -> int:
    """Worst-case number of groups: every probed partition needs
    ceil(count/QT) groups; counts sum to B*nprobe and there are at most
    min(B*nprobe, nlist_cap) distinct partitions."""
    n_pairs = B * nprobe
    max_unique = min(n_pairs, nlist_cap)
    return max_unique + n_pairs // qt


def _sorted_groups(pids: torch.Tensor, nlist_cap: int, qt: int):
    """Shared prologue of build_groups and build_groups_scatter.

    One sort of the unique key (pid+1)*n + flat_index orders the pairs by
    (partition, flat index) — the stable order; int64 keys never overflow,
    so the JAX package's argsort branch for huge shapes is not needed. Run
    offsets come from a left-side searchsorted; each populated partition
    stamps p+1 at its first group (scatter-max) and a running max fills its
    groups. Returns (group_pid [G] int64, order [n] sorted position ->
    flat pair index, offs [P+1] run offsets, gbase [P] first group of each
    partition, tgt_raw [G, qt] flat pair index of each kernel row, valid
    [G, qt] whether that row holds a pair)."""
    B, nprobe = pids.shape
    G = group_layout(B, nprobe, nlist_cap, qt)
    n = B * nprobe
    P = nlist_cap
    dev = pids.device
    flat_pid = pids.reshape(-1).to(torch.int64)
    iota_n = torch.arange(n, device=dev, dtype=torch.int64)

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
    stamp_at = torch.where(groups_of > 0, gbase, torch.full_like(gbase, G))
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
    tgt_raw = order[torch.clamp(pos, 0, n - 1)]
    valid = g_valid[:, None] & in_run
    return group_pid, order, offs, gbase, tgt_raw, valid


def build_groups_scatter(pids: torch.Tensor, nlist_cap: int, qt: int):
    """Invert per-query probe lists into partition-major groups (the v11
    layout).

    pids: [B, nprobe] int (-1 = pad). Returns int32 tensors:
      group_pid [G]      partition of each group (-1 = unused)
      qlist     [G, QT]  query indices per group (-1 = pad)
      tgt       [G, QT]  flat pair index (b*nprobe + j) of each kernel row;
                         n = B*nprobe for invalid rows
    """
    B, nprobe = pids.shape
    n = B * nprobe
    group_pid, _, _, _, tgt_raw, valid = _sorted_groups(pids, nlist_cap, qt)
    qlist = torch.where(valid, tgt_raw // nprobe, torch.full_like(tgt_raw, -1))
    tgt = torch.where(valid, tgt_raw, torch.full_like(tgt_raw, n))
    return (group_pid.to(torch.int32), qlist.to(torch.int32),
            tgt.to(torch.int32))


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
