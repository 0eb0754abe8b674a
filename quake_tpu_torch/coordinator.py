"""Search execution for the fixed-nprobe path (the main-path part of
quake_tpu/coordinator.py): parent ranking, the dense-pid self-heal, the
grouped-scan dispatch and the distance conversion."""

from __future__ import annotations

import re

import torch

from quake_tpu_torch.ops.flat_topk import MAX_N, parent_rank
from quake_tpu_torch.ops.grouped import group_layout
from quake_tpu_torch.ops.grouped_scan import (FOLD, grouped_scan_v11,
                                              sort_key_fits)
from quake_tpu_torch.ops.scan import NEG_INF, scores_to_distances, topk_from_scores


def flat_scan_topk(q, codes2d, ids_flat, k: int, metric: str):
    """Exact top-k of queries against a flat buffer (ids -1 = invalid slot).
    Returns (scores [B, k], ids [B, k])."""
    qf = q.to(torch.float32)
    x = codes2d.to(torch.float32)
    prod = qf @ x.T
    if metric == "l2":
        scores = (2.0 * prod - torch.sum(qf * qf, dim=1, keepdim=True)
                  - torch.sum(x * x, dim=1)[None, :])
    else:
        scores = prod
    scores = torch.where((ids_flat >= 0)[None, :], scores, torch.full_like(scores, NEG_INF))
    return topk_from_scores(scores, ids_flat[None, :].expand(scores.shape), k)


def rank_parents(parent_codes, parent_ids, parent_norms, q, nprobe: int,
                 metric: str):
    """Ranked candidate partitions (the recursive parent search,
    query_coordinator.cpp:628-646) through kernel K3 (ops/flat_topk.py).
    Outside K3's preconditions (cached norms, N % 128 == 0, N <= 16384) this
    takes an exact top-k of the parent scores, where the JAX package falls
    back to its approx_max_k scan."""
    Pp, Cp, D = parent_codes.shape
    N = Pp * Cp
    if parent_norms is not None and N % FOLD == 0 and N <= MAX_N:
        return parent_rank(parent_codes, parent_ids, parent_norms, q, nprobe, metric)
    _, pids = flat_scan_topk(q, parent_codes.reshape(N, D), parent_ids.reshape(N),
                             nprobe, metric)
    return pids


def reference_scan(codes, ids, norms, q, pids, k: int, metric: str,
                   max_bytes: int = 1 << 28):
    """Plain exact reference of the grouped scan: every query scores all
    slots of its probed partitions and keeps an exact top-k. Chunked over
    queries so the gathered slabs stay below max_bytes. Returns (scores,
    ids int32, scanned)."""
    B, nprobe = pids.shape
    P, C, D = codes.shape
    qf = q.to(torch.float32)
    step = max(1, max_bytes // max(nprobe * C * D * 4, 1))
    out_s, out_i = [], []
    for b0 in range(0, B, step):
        pb = pids[b0:b0 + step].long()
        ok = pb >= 0
        safe = torch.clamp(pb, min=0)
        slab = codes[safe].reshape(pb.shape[0], nprobe * C, D)
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


_V11 = re.compile(r"v11(?:g(\d+))?(?:f(\d+))?$")


def grouped_scan(codes, ids, sizes, norms, q, pids, k: int, metric: str,
                 qt: int, kernel: str, dense: bool = True, stages=None):
    """Grouped-scan dispatch. kernel "v11g{gpb}" (optionally "f{fold}") runs
    the v11 scan on kernel K1; "reference" runs the plain exact scan. The
    v11 placement follows the JAX dispatch: sorted while its uint32 key
    fits, else argsort."""
    m = _V11.match(kernel)
    if kernel == "reference":
        return reference_scan(codes, ids, norms, q, pids, k, metric)
    if m is None:
        raise NotImplementedError(
            f"grouped-scan kernel {kernel!r}: only 'v11g{{gpb}}' and 'reference' "
            "are ported (ROADMAP Queue 2: remaining kernels)")
    if not dense:
        raise NotImplementedError("masked pid matrices (v10 scatter epilogue): "
                                  "ROADMAP Queue 1 item 9 (APS)")
    gpb = int(m.group(1) or 4)
    fold = int(m.group(2) or FOLD)
    B, nprobe = pids.shape
    P, C, _ = codes.shape
    if C % fold:
        raise NotImplementedError(
            f"C % {fold} != 0 takes the v3pn fallback in the JAX package: "
            "ROADMAP Queue 2 (_v3pn_kernel)")
    rows = -(-group_layout(B, nprobe, P, qt) // gpb) * gpb * qt
    placement = "sorted" if sort_key_fits(B, rows) else "argsort"
    return grouped_scan_v11(codes, ids, sizes, norms, q, pids, k, metric,
                            qt=qt, gpb=gpb, fold=fold, placement=placement,
                            stages=stages)


def fused_ivf_search(codes, ids, sizes, norms, parent_codes, parent_ids, q,
                     k: int, nprobe: int, metric: str, qt: int,
                     kernel: str = "v11g4", parent_norms=None, stages=None):
    """End-to-end fixed-nprobe search: parent centroid ranking -> grouped
    scan -> top-k merge -> distance conversion. All launches go to the
    current stream; nothing synchronises.

    Returns (scores, ids32, distances, scanned, pids)."""
    if stages is not None:
        stages.start()
    pids = rank_parents(parent_codes, parent_ids, parent_norms, q, nprobe, metric)
    # Self-heal the dense invariant: a -1 pid would drop its pair from the
    # grouping and shift the sorted placement's windows for every query.
    # Substitute the query's best (always-valid) parent; duplicates collapse
    # downstream.
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    if stages is not None:
        stages.mark("parent")
    scores, ids32, scanned = grouped_scan(codes, ids, sizes, norms, q, pids, k,
                                          metric, qt, kernel, dense=True,
                                          stages=stages)
    dists = scores_to_distances(scores, ids32, metric)
    if stages is not None:
        stages.mark("distances")
        stages.stop()
    return scores, ids32, dists, scanned, pids
