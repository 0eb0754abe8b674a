"""k-means for the index build: Lloyd iterations as matmul + argmax +
index_add (the counterpart of quake_tpu/kmeans.py).

Replaces the reference's Faiss-backed clustering (src/cpp/src/clustering.cpp:
13-97) with the same semantics: spherical normalization for the
inner-product metric during training (clustering.cpp:25-26), training on a
256-points-per-centroid subsample, empty clusters re-seeded with a random
data point, final exact assignment of every vector. The products go to
torch.matmul in f32, as the JAX package leaves them to XLA.

Random choices (initial centroids, subsample, re-seed points) come from a
torch.Generator seeded with `seed`; they cannot reproduce jax.random's bits,
so the two packages agree in clustering quality, not in assignments.

`kmeans_np` and `balance_clusters` are host numpy copies of the JAX
package's (build-time balancing of oversized clusters).
"""

from __future__ import annotations

import numpy as np
import torch


def _assign(chunk, cents, cents_sq, metric: str):
    """Nearest (l2) / max-inner-product (ip) centroid of each row."""
    prod = chunk @ cents.T
    if metric == "l2":
        scores = 2.0 * prod - cents_sq[None, :]  # - ||x||^2 is row-constant
    else:
        scores = prod
    return torch.argmax(scores, dim=1)


def _assign_all(x, cents, metric: str, chunk_size: int):
    cents_sq = torch.sum(cents * cents, dim=1)
    return torch.cat([_assign(x[s:s + chunk_size], cents, cents_sq, metric)
                      for s in range(0, x.shape[0], chunk_size)])


def _normalized(c):
    return c / torch.clamp(torch.linalg.norm(c, dim=1, keepdim=True), min=1e-12)


def kmeans_fit_assign(x, n_clusters: int, metric: str = "l2", niter: int = 5,
                      seed: int = 0, chunk_size: int = 65536):
    """Train k-means and assign. x: [n, d] f32 tensor (on the device that
    runs the build).

    Returns (centroids [n_clusters, d] f32, assignments [n] int64), both on
    x's device.
    """
    n, d = x.shape
    dev = x.device
    x = x.to(torch.float32)
    gen = torch.Generator().manual_seed(int(seed))
    if n >= n_clusters:
        init = torch.randperm(n, generator=gen)[:n_clusters]
    else:
        init = torch.randint(0, max(n, 1), (n_clusters,), generator=gen)
    centroids = x[init.to(dev)].clone()

    # Faiss's max_points_per_centroid = 256: Lloyd quality saturates beyond
    # ~256 points per centroid and each iteration costs proportionally less.
    max_train = 256 * n_clusters
    x_train = x
    if n > max_train:
        x_train = x[torch.randperm(n, generator=gen)[:max_train].to(dev)]
    n_train = x_train.shape[0]
    reseed = torch.randint(0, max(n_train, 1), (max(niter, 1), n_clusters),
                           generator=gen).to(dev)

    for i in range(niter):
        cents = _normalized(centroids) if metric == "ip" else centroids
        a = _assign_all(x_train, cents, metric, chunk_size)
        sums = torch.zeros((n_clusters, d), device=dev, dtype=torch.float32)
        sums.index_add_(0, a, x_train)
        counts = torch.bincount(a, minlength=n_clusters).to(torch.float32)
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        empty = counts < 0.5
        centroids = torch.where(empty[:, None], x_train[reseed[i]], new_c)

    # Final exact assignment of the FULL dataset (clustering.cpp:63-66).
    if metric == "ip":
        centroids = _normalized(centroids)
    assignments = _assign_all(x, centroids, metric, chunk_size)
    return centroids, assignments


# ---------------------------------------------------------------------------
# Host-side small-scale clustering (build-time balancing), numpy copies.
# ---------------------------------------------------------------------------


def kmeans_np(x, ids, n_clusters: int, metric: str = "l2", niter: int = 5, seed: int = 0):
    """Small host k-means. Returns (centroids [nc, d], [(vecs, ids)] per cluster).

    Mirrors the semantics of reference kmeans (clustering.cpp:13-97) for the
    2-way split path (partition_manager.cpp:393-445).
    """
    x = np.asarray(x, dtype=np.float32)
    ids = np.asarray(ids, dtype=np.int64)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if n == 0:
        cents = np.zeros((n_clusters, d), np.float32)
        return cents, [(x[:0], ids[:0]) for _ in range(n_clusters)]
    init = rng.choice(n, size=min(n_clusters, n), replace=False)
    cents = x[init].copy()
    if len(init) < n_clusters:
        cents = np.concatenate([cents, x[rng.integers(0, n, n_clusters - len(init))]])
    for _ in range(max(niter, 1)):
        if metric == "ip":
            cn = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
            assign = np.argmax(x @ cn.T, axis=1)
        else:
            d2 = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(-1) if n * n_clusters * d < 2**24 \
                else (x**2).sum(1)[:, None] - 2 * x @ cents.T + (cents**2).sum(1)[None, :]
            assign = np.argmin(d2, axis=1)
        for c in range(n_clusters):
            mask = assign == c
            if mask.any():
                cents[c] = x[mask].mean(0)
            else:
                cents[c] = x[rng.integers(0, n)]
    if metric == "ip":
        cents = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
        assign = np.argmax(x @ cents.T, axis=1)
    else:
        d2 = (x**2).sum(1)[:, None] - 2 * x @ cents.T + (cents**2).sum(1)[None, :]
        assign = np.argmin(d2, axis=1)
    clusters = [(x[assign == c], ids[assign == c]) for c in range(n_clusters)]
    return cents.astype(np.float32), clusters


def balance_clusters(x, centroids, assignments, cap: int, max_rounds: int = 12,
                     seed: int = 0):
    """Split oversized clusters until every cluster has <= cap members.

    The padded store's slab capacity C is set by the LARGEST partition, and
    the scan's work per partition grows with it — so cluster imbalance
    directly multiplies scan cost. The reference
    tolerates imbalance (per-partition heap buffers); here we bound it at
    build time with recursive 2-way splits (the same operation its
    maintenance uses for hot partitions, partition_manager.cpp:393-445).

    x: [n, d] np; centroids: [nlist, d]; assignments: [n] int.
    Returns (centroids, assignments) with possibly more clusters.
    """
    x = np.asarray(x, dtype=np.float32)
    centroids = np.asarray(centroids, dtype=np.float32).copy()
    assignments = np.asarray(assignments).astype(np.int64).copy()
    for _ in range(max_rounds):
        nlist = centroids.shape[0]
        counts = np.bincount(assignments, minlength=nlist)
        oversized = np.where(counts > cap)[0]
        if len(oversized) == 0:
            break
        new_cents = []
        for c in oversized:
            members = np.where(assignments == c)[0]
            sub_cents, clusters = kmeans_np(
                x[members], members, 2, niter=4, seed=seed + int(c)
            )
            # Guard: degenerate split (all points identical) — leave as-is.
            if len(clusters[0][1]) == 0 or len(clusters[1][1]) == 0:
                continue
            centroids[c] = sub_cents[0]
            assignments[clusters[1][1]] = nlist + len(new_cents)
            new_cents.append(sub_cents[1])
        if not new_cents:
            break
        centroids = np.concatenate([centroids, np.stack(new_cents)])
    return centroids, assignments
