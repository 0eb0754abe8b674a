"""Utility helpers: array conversion, recall computation, brute-force kNN,
and ANN-benchmark file formats.

A copy of quake_tpu/utils.py, mirroring reference src/python/utils.py
(compute_recall :167-183, knn :200-229, fvecs/ivecs/fbin/ibin readers
:139-164).
"""

from __future__ import annotations

import numpy as np


def to_numpy(x, dtype=None) -> np.ndarray:
    """Convert numpy/torch/list input to a contiguous numpy array."""
    if hasattr(x, "detach"):  # torch tensor, on any device
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if dtype is not None and arr.dtype != dtype:
        arr = arr.astype(dtype)
    return np.ascontiguousarray(arr)


def to_f32(x) -> np.ndarray:
    return to_numpy(x, np.float32)


def to_i64(x) -> np.ndarray:
    return to_numpy(x, np.int64)


def compute_recall(ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Set-overlap recall@k averaged over queries (reference utils.py:167-183).

    `ids` and `gt_ids` are [nq, >=k]; -1 entries are ignored.
    """
    ids = to_i64(ids)[:, :k]
    gt_ids = to_i64(gt_ids)[:, :k]
    nq = ids.shape[0]
    if nq == 0:
        return 0.0
    total = 0.0
    for q in range(nq):
        gt = set(int(v) for v in gt_ids[q] if v >= 0)
        if not gt:
            continue
        found = sum(1 for v in ids[q] if int(v) >= 0 and int(v) in gt)
        total += found / len(gt)
    return float(total / nq)


def first_k_stable(d: np.ndarray, k: int) -> np.ndarray:
    """np.argsort(d, axis=1, kind="stable")[:, :k], equal to it element for
    element, without sorting whole rows: a row's k smallest values and every
    value tied with the k-th, found by a partition, are sorted stably in
    index order (the order a stable sort gives equal values). A row where
    that leaves fewer than k (NaNs) is sorted whole."""
    n = d.shape[1]
    if k >= n:
        return np.argsort(d, axis=1, kind="stable")[:, :k]
    part = np.argpartition(d, k - 1, axis=1)[:, :k]
    kth = np.take_along_axis(d, part, 1).max(axis=1)
    out = np.empty((d.shape[0], k), dtype=np.int64)
    for i in range(d.shape[0]):
        cand = np.flatnonzero(d[i] <= kth[i])
        if cand.shape[0] < k:
            out[i] = np.argsort(d[i], kind="stable")[:k]
        else:
            out[i] = cand[np.argsort(d[i, cand], kind="stable")[:k]]
    return out


def knn(queries, vectors, k: int, metric: str = "l2", ids=None, batch_size: int = 1024):
    """Brute-force exact kNN oracle (reference utils.py:200-229).

    Runs on host with numpy so tests have a device-independent oracle.
    Returns (ids [nq,k] int64, distances [nq,k] float32). L2 distances are
    sqrt'd to match reference scan output (list_scanning.h:260). The same
    arrays as quake_tpu/utils.py::knn, whose whole-row stable sort is
    first_k_stable here.
    """
    q = to_f32(queries)
    v = to_f32(vectors)
    n = v.shape[0]
    k = min(k, n)
    if ids is None:
        ids = np.arange(n, dtype=np.int64)
    else:
        ids = to_i64(ids)
    out_ids = np.empty((q.shape[0], k), dtype=np.int64)
    out_d = np.empty((q.shape[0], k), dtype=np.float32)
    v64t = v.T.astype(np.float64)
    v_sq = (v64t.T**2).sum(axis=1)
    for s in range(0, q.shape[0], batch_size):
        qb = q[s : s + batch_size].astype(np.float64)
        if metric == "l2":
            # q2 - (2 q) @ v.T + v2, clamped at 0: the JAX package's
            # expression, evaluated in place.
            d2 = (2.0 * qb) @ v64t
            np.subtract((qb**2).sum(1)[:, None], d2, out=d2)
            d2 += v_sq[None, :]
            np.maximum(d2, 0.0, out=d2)
            order = first_k_stable(d2, k)
            out_d[s : s + batch_size] = np.sqrt(np.take_along_axis(d2, order, 1)).astype(np.float32)
        else:
            ip = qb @ v64t
            order = first_k_stable(-ip, k)
            out_d[s : s + batch_size] = np.take_along_axis(ip, order, 1).astype(np.float32)
        out_ids[s : s + batch_size] = ids[order]
    return out_ids, out_d


# ---------------------------------------------------------------------------
# ANN-benchmark file formats (reference utils.py:139-164)
# ---------------------------------------------------------------------------


def fvecs_read(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    d = raw[0]
    return raw.reshape(-1, d + 1)[:, 1:].view(np.float32).copy()


def ivecs_read(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.int32)
    d = raw[0]
    return raw.reshape(-1, d + 1)[:, 1:].copy()


def fbin_read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = np.fromfile(f, dtype=np.int32, count=2)
        return np.fromfile(f, dtype=np.float32, count=n * d).reshape(n, d)


def ibin_read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = np.fromfile(f, dtype=np.int32, count=2)
        return np.fromfile(f, dtype=np.int32, count=n * d).reshape(n, d)


def fvecs_write(path: str, x: np.ndarray) -> None:
    x = to_f32(x)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x.view(np.int32)
    out.tofile(path)


def ivecs_write(path: str, x: np.ndarray) -> None:
    x = to_numpy(x, np.int32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x
    out.tofile(path)


def next_pow2(n: int, floor: int = 1) -> int:
    n = max(int(n), floor)
    p = floor
    while p < n:
        p *= 2
    return p
