"""Search execution for the flat and the fixed-nprobe paths (that part of
quake_tpu/coordinator.py): the flat and the query-major searches, parent
ranking, the dense-pid self-heal, the grouped-scan dispatch by kernel name
and the distance conversion."""

from __future__ import annotations

import os
import re

import torch

from quake_tpu_torch.ops.flat_topk import MAX_N, parent_rank
from quake_tpu_torch.ops.grouped import group_layout, grouped_scan_xla
from quake_tpu_torch.ops.grouped_chunked import (grouped_scan_v4, grouped_scan_v5,
                                                 grouped_scan_v6)
from quake_tpu_torch.ops.grouped_exact import grouped_scan_v2, grouped_scan_v3
from quake_tpu_torch.ops.grouped_family import (grouped_scan_v3p, grouped_scan_v3pn,
                                                grouped_scan_v7, grouped_scan_v8)
from quake_tpu_torch.ops.grouped_scan import (FOLD, grouped_scan_v10, grouped_scan_v11,
                                              sort_key_fits)
from quake_tpu_torch.ops.scan import (NEG_INF, flat_scan, ivf_scan, scores_to_distances,
                                      topk_from_scores)


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
                 dense: bool = False, exact: bool = True, stages=None):
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
    C % fold != 0. dense promises that every pid is valid (fixed-nprobe
    semantics); v11 needs it and rides v10 without it. The v11 placement is
    sorted while its uint32 key fits, else argsort, or v10 where
    QUAKE_TPU_V11_OVERFLOW=v10; QUAKE_TPU_V11_PLACEMENT=argsort forces
    argsort where the key fits (both read at each call, as in the JAX
    package). Folds other than 128 (with C % fold == 0) raise
    NotImplementedError; dedup on v2/v3/v3p raises the JAX package's
    ValueError, and on every other name NotImplementedError. exact=False
    (dequantized scores) reaches v10 and v11 only; every other name rescores
    exactly, as in the JAX package. bf16 codes run on v8-v11 (K1's bf16
    body), "xla" and "reference"; the names whose kernels have no bf16 body
    (v3p, v3pN, v6, v7, v4, v5, v3, v2) raise NotImplementedError."""
    if kernel == "reference":
        return reference_scan(codes, ids, norms, q, pids, k, metric)
    if kernel[:2] in ("v4", "v5", "v6"):
        fn, gpb = {"v4": (grouped_scan_v4, 8), "v5": (grouped_scan_v5, 4),
                   "v6": (grouped_scan_v6, 4)}[kernel[:2]]
        ct, gpb = chunk_spec(kernel, codes.shape[1], gpb)
        return fn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt, ct=ct, gpb=gpb,
                  dedup=dedup, stages=stages)
    if dedup and kernel in ("v2", "v3", "v3p"):
        raise ValueError(
            f"kernel {kernel!r} does not support dedup (spilled stores); "
            "use the default v3pN, v4, v5/v6, v7, or xla backends")
    m = _FOLDED.match(kernel)
    if m is not None:
        name, gpb, fold = m.group(1), int(m.group(2) or 4), int(m.group(3) or FOLD)
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
        if codes.shape[1] % fold:
            return grouped_scan_v3pn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                     gpb=gpb, dedup=dedup, stages=stages)
        if fold != FOLD:
            raise NotImplementedError(
                f"fold={fold}: kernels K1, K2 and K5 fold by 128 (ROADMAP Queue 2, "
                "what the grouped-scan slice left out)")
        if name == "v7":
            return grouped_scan_v7(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                   gpb=gpb, dedup=dedup, stages=stages)
        if name in ("v8", "v9"):  # v9 computes v8's function (grouped_family.py)
            return grouped_scan_v8(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                   gpb=gpb, dedup=dedup, stages=stages)
        if name == "v10":
            return grouped_scan_v10(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                    gpb=gpb, dedup=dedup, exact=exact, stages=stages)
        return grouped_scan_v11(codes, ids, sizes, norms, q, pids, k, metric,
                                qt=qt, gpb=gpb, dedup=dedup, exact=exact,
                                placement=placement, stages=stages)
    m = _V3PN.match(kernel)
    if m is not None:
        return grouped_scan_v3pn(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                 gpb=int(m.group(1)), dedup=dedup, stages=stages)
    if kernel == "v3p":
        return grouped_scan_v3p(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                                stages=stages)
    if kernel == "v3":
        return grouped_scan_v3(codes, ids, sizes, norms, q, pids, k, metric, qt=qt,
                               stages=stages)
    if kernel == "v2":
        return grouped_scan_v2(codes, ids, q, pids, k, metric, qt=qt, stages=stages)
    return grouped_scan_xla(codes, ids, q, pids, k, metric, qt=qt, group_chunk=group_chunk,
                            norms=norms, dedup=dedup, stages=stages)


def fused_ivf_search(codes, ids, sizes, norms, parent_codes, parent_ids, q,
                     k: int, nprobe: int, metric: str, qt: int,
                     kernel: str = "v11g4", parent_norms=None, group_chunk: int = 64,
                     parent_kernel: str = "approx", exact: bool = True, stages=None):
    """End-to-end fixed-nprobe search: parent centroid ranking -> grouped
    scan -> top-k merge -> distance conversion. exact=False: dequantized
    scores on v10 and v11 (see grouped_scan). All launches go to the
    current stream; nothing synchronises.

    Returns (scores, ids32, distances, scanned, pids)."""
    if stages is not None:
        stages.start()
    pids = rank_parents(parent_codes, parent_ids, parent_norms, q, nprobe, metric,
                        parent_kernel)
    # Self-heal the dense invariant: a -1 pid would drop its pair from the
    # grouping and shift the sorted placement's windows for every query.
    # Substitute the query's best (always-valid) parent; duplicates collapse
    # downstream.
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    if stages is not None:
        stages.mark("parent")
    scores, ids32, scanned = grouped_scan(codes, ids, sizes, norms, q, pids, k,
                                          metric, qt, group_chunk, kernel, dense=True,
                                          exact=exact, stages=stages)
    dists = scores_to_distances(scores, ids32, metric)
    if stages is not None:
        stages.mark("distances")
        stages.stop()
    return scores, ids32, dists, scanned, pids
