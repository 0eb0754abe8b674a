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

`kmeans_np`, `balance_clusters` and `lloyd_refine_np` are host numpy copies
of the JAX package's (build-time balancing, the host paths of maintenance).
`batched_two_means` and `batched_refine`, maintenance's split and refinement,
are batched tensor programs on the index's device, as the JAX package's are;
`soar_assign`, a spilled build's second partition per vector, too.
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
                     seed: int = 0, metric: str = "l2"):
    """Split oversized clusters until every cluster has <= cap members.

    The padded store's slab capacity C is set by the LARGEST partition, and
    the scan's work per partition grows with it — so cluster imbalance
    directly multiplies scan cost. The reference
    tolerates imbalance (per-partition heap buffers); here we bound it at
    build time with recursive 2-way splits (the same operation its
    maintenance uses for hot partitions, partition_manager.cpp:393-445).

    Each split runs kmeans_np at the build's `metric`, so an ip build's
    split centroids stay unit-norm, as the reference's k-means normalizes
    them for IP (clustering.cpp:25-26); the JAX package splits at l2 whatever
    the metric (a deliberate deviation, ROADMAP.md Queue 3). A round takes
    every oversized cluster's members, in ascending order as np.where gives
    them, from one stable argsort of the assignments.

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
        order = np.argsort(assignments, kind="stable")
        starts = np.cumsum(counts) - counts
        new_cents = []
        for c in oversized:
            members = order[starts[c]:starts[c] + counts[c]]
            sub_cents, clusters = kmeans_np(
                x[members], members, 2, metric=metric, niter=4, seed=seed + int(c)
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


def soar_assign(x, centroids, lam: float = 1.0, batch: int = 65536, primary=None,
                device="cpu"):
    """Primary and spill partition of each vector (SOAR, ScaNN NeurIPS'23;
    quake_tpu/kmeans.py::soar_assign, in the same forms, so that the two
    packages assign alike):

        spill = argmin_{j != primary} ||x - c_j||^2 + lam * (r_j . r1_hat)^2

    with r1_hat the unit primary residual: a spill residual parallel to the
    primary one is penalized, so whichever partition a query probes, one
    copy's quantization error is unlikely to point away from it; lam = 0 is
    plain second-nearest spilling. `primary`: an optional [n] precomputed
    primary assignment (the build's balanced one), else the nearest
    centroid. The products run as torch.matmul on `device`, `batch` rows
    at a time. Returns (a1 [n] int32, a2 [n] int32) as numpy."""
    dev = torch.device(device)
    x = np.asarray(x, dtype=np.float32)
    cj = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32)).to(dev)
    c_sq = torch.sum(cj * cj, dim=1)
    n = x.shape[0]
    a1 = np.empty(n, np.int32)
    a2 = np.empty(n, np.int32)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        xb = torch.from_numpy(x[s:e]).to(dev)
        d2 = -2.0 * (xb @ cj.T) + c_sq[None, :]  # + ||x||^2 is rank-invariant
        if primary is None:
            p = torch.argmin(d2, dim=1)
        else:
            p = torch.from_numpy(np.asarray(primary[s:e]).astype(np.int64)).to(dev)
        r1 = xb - cj[p]
        r1n = r1 / torch.clamp(torch.linalg.norm(r1, dim=1, keepdim=True), min=1e-9)
        dot = torch.sum(xb * r1n, dim=1, keepdim=True) - r1n @ cj.T
        score = d2 + lam * dot * dot
        score[torch.arange(e - s, device=dev), p] = float("inf")
        a1[s:e] = p.cpu().numpy()
        a2[s:e] = torch.argmin(score, dim=1).cpu().numpy()
    return a1, a2


def lloyd_refine_np(vec_list, id_list, centroids, metric: str = "l2", iterations: int = 3):
    """Constrained Lloyd refinement among an existing partition neighborhood
    (reference kmeans_refine_partitions, clustering.cpp:99-182), a numpy copy
    of the JAX package's: pool the partitions' vectors, reassign among only
    these centroids, recompute the means (an empty cluster keeps its
    centroid).

    Returns (new_centroids, [(vecs, ids)] per input partition slot)."""
    cents = np.asarray(centroids, dtype=np.float32).copy()
    m, d = cents.shape
    x = np.concatenate([np.asarray(v, np.float32).reshape(-1, d) for v in vec_list]) \
        if vec_list else np.zeros((0, d), np.float32)
    ids = np.concatenate([np.asarray(i, np.int64) for i in id_list]) \
        if id_list else np.zeros((0,), np.int64)
    if x.shape[0] == 0:
        return cents, [(x[:0], ids[:0]) for _ in range(m)]
    assign = None
    for _ in range(max(iterations, 1)):
        if metric == "ip":
            assign = np.argmax(x @ cents.T, axis=1)
        else:
            d2 = (x**2).sum(1)[:, None] - 2 * x @ cents.T + (cents**2).sum(1)[None, :]
            assign = np.argmin(d2, axis=1)
        for c in range(m):
            mask = assign == c
            if mask.any():
                cents[c] = x[mask].mean(0)
    clusters = [(x[assign == c], ids[assign == c]) for c in range(m)]
    return cents, clusters


# ---------------------------------------------------------------------------
# Maintenance clustering on the index's device (quake_tpu/kmeans.py:319-459).
# ---------------------------------------------------------------------------


def _gather_slabs(codes, ids, sizes_all, rows_p):
    """The slabs of rows_p (-1 pads: no valid row) as f32, with their ids,
    sizes, validity mask and the vectors with invalid rows zeroed."""
    rows_c = torch.clamp(rows_p, min=0).long()
    x = codes[rows_c].to(torch.float32)  # [S, C, D]
    slab_ids = ids[rows_c]
    sizes = torch.where(rows_p >= 0, sizes_all[rows_c], torch.zeros_like(rows_p)).to(torch.int32)
    C = x.shape[1]
    valid = torch.arange(C, device=x.device, dtype=torch.int32)[None, :] < sizes[:, None]
    xm = torch.where(valid[..., None], x, torch.zeros_like(x))
    return x, slab_ids, sizes, valid, xm


def _farthest(xm, valid, point):
    """Per slab, the valid vector farthest (squared l2) from point [S, D];
    index 0 for a slab with none, as jnp.argmax of all -inf gives."""
    d2 = torch.sum((xm - point[:, None, :]) ** 2, dim=-1)
    pick = torch.argmax(torch.where(valid, d2, torch.full_like(d2, float("-inf"))), dim=1)
    return xm[torch.arange(xm.shape[0], device=xm.device), pick]


def batched_two_means(codes, ids, sizes_all, rows_p, niter: int = 5, metric: str = "l2"):
    """2-means over a set of partition slabs in one batched program
    (quake_tpu/kmeans.py::batched_two_means): the maintenance split's
    clustering, without a host round trip a partition (reference semantics
    partition_manager.cpp:393-445).

    codes [P, C, D] (f32 or bf16), ids [P, C], sizes_all [P] int32, rows_p
    [Sb] int32 (split rows, -1 pads), all on one device. Returns (slabs f32
    [Sb, C, D], slab_ids [Sb, C], sizes [Sb], cents [Sb, 2, D], assign
    [Sb, C] int32 in {0, 1}, -1 past the size).

    As in the JAX package: the init is deterministic (the first valid vector,
    then the valid vector farthest from it); l2 assigns by the broadcast sum
    of squared differences (not the expanded product: that would flip
    near-ties against the JAX package), ip by the inner product with the
    normalized centroids, and returns them normalized; an empty half is
    reseeded each iteration to the point farthest from the other half."""
    x, slab_ids, sizes, valid, xm = _gather_slabs(codes, ids, sizes_all, rows_p)
    c0 = xm[:, 0, :]
    cents = torch.stack([c0, _farthest(xm, valid, c0)], dim=1)  # [Sb, 2, D]

    def assign_step(cents):
        if metric == "ip":
            ca = cents / torch.clamp(torch.linalg.norm(cents, dim=-1, keepdim=True), min=1e-12)
            a = torch.argmax(torch.einsum("scd,sjd->scj", xm, ca), dim=-1)
        else:
            d2 = torch.sum((xm[:, :, None, :] - cents[:, None, :, :]) ** 2, dim=-1)
            a = torch.argmin(d2, dim=-1)
        return torch.where(valid, a, torch.full_like(a, -1))

    for _ in range(max(niter, 1)):
        a = assign_step(cents)
        new_c = []
        for j in (0, 1):
            w = (a == j).to(torch.float32)  # [Sb, C]
            s = torch.einsum("scd,sc->sd", xm, w)
            n = torch.sum(w, dim=1, keepdim=True)
            new_c.append(torch.where(n > 0, s / torch.clamp(n, min=1.0), cents[:, j, :]))
        cents = torch.stack(new_c, dim=1)
        counts = [torch.sum((a == j) & valid, dim=1) for j in (0, 1)]
        for j in (0, 1):
            cand = _farthest(xm, valid, cents[:, 1 - j, :])
            upd = torch.where((counts[j] == 0)[:, None], cand, cents[:, j, :])
            cents = torch.stack([upd, cents[:, 1, :]] if j == 0 else [cents[:, 0, :], upd],
                                dim=1)
    if metric == "ip":
        cents = cents / torch.clamp(torch.linalg.norm(cents, dim=-1, keepdim=True), min=1e-12)
    return x, slab_ids, sizes, cents, assign_step(cents).to(torch.int32)


def batched_refine(codes, ids, sizes_all, centroids_all, rows_p, niter: int = 3,
                   metric: str = "l2"):
    """Constrained Lloyd over a partition neighborhood in one batched program
    (quake_tpu/kmeans.py::batched_refine; reference semantics
    clustering.cpp:99-182): the gathered slabs pooled, every valid vector
    reassigned among only the neighborhood's centroids, the means as segment
    sums. The initial centroids are the stored ones, so an empty partition
    keeps its own.

    rows_p [Rb] int32 with -1 pads. Returns (slabs f32 [Rb, C, D], slab_ids
    [Rb, C], sizes [Rb], new_cents [Rb, D], assign [Rb, C] int32: the slot
    in rows_p, -1 past the size).

    As in lloyd_refine_np: ip assigns by the raw inner product (unnormalized
    means, as the reference refines them), l2 by c_sq - 2 x.c (the JAX
    package's expanded form); empty clusters keep their previous centroid.
    The segment sums are index_add_, whose float32 atomics on a CUDA device
    add in no fixed order: the means agree with the JAX package's within
    f32 rounding, not bit for bit."""
    x, slab_ids, sizes, valid, xm = _gather_slabs(codes, ids, sizes_all, rows_p)
    cents = centroids_all[torch.clamp(rows_p, min=0).long()].to(torch.float32)
    Rb, C, D = x.shape
    flat_x = xm.reshape(Rb * C, D)
    flat_valid = valid.reshape(Rb * C)
    row_live = rows_p >= 0

    def assign_step(cents):
        prod = flat_x @ cents.T  # [Rb*C, Rb]
        if metric == "ip":
            a = torch.argmax(torch.where(row_live[None, :], prod,
                                         torch.full_like(prod, float("-inf"))), dim=-1)
        else:
            d2 = torch.sum(cents * cents, dim=1)[None, :] - 2.0 * prod
            a = torch.argmin(torch.where(row_live[None, :], d2,
                                         torch.full_like(d2, float("inf"))), dim=-1)
        return torch.where(flat_valid, a, torch.full_like(a, Rb))  # invalid: an extra segment

    for _ in range(max(niter, 1)):
        a = assign_step(cents)
        s = torch.zeros((Rb + 1, D), device=x.device, dtype=torch.float32)
        s.index_add_(0, a, flat_x)
        n = torch.zeros(Rb + 1, device=x.device, dtype=torch.float32)
        n.index_add_(0, a, flat_valid.to(torch.float32))
        s, n = s[:Rb], n[:Rb]
        cents = torch.where((n > 0)[:, None], s / torch.clamp(n[:, None], min=1.0), cents)
    a = assign_step(cents)
    assign = torch.where(flat_valid, a, torch.full_like(a, -1)).to(torch.int32).reshape(Rb, C)
    return x, slab_ids, sizes, cents, assign
