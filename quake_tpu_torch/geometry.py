"""APS recall-estimation geometry, batched over queries (a copy of
quake_tpu/geometry.py in tensor operations), and the build's effective
dimension.

The reference's hyperspherical-cap recall model (src/cpp/include/geometry.h):
the regularized incomplete beta function, which the reference evaluates with
Lentz continued fractions (geometry.h:115-161), is `betainc` below (torch has
none); the 1001-entry precomputed lookup table (geometry.h:163-211) is a
constant tensor kept on each device, read with linear interpolation and
selected by SearchParams.use_precomputed.

Semantics preserved (geometry.h:345-407):
  * the boundary distance of the rank-0 (nearest) centroid is a placeholder;
    its probability is set to 2x the rank-1 probability before normalization.
  * partitions whose boundary is beyond the query radius get probability 0.
  * the profile is normalized to sum to 1 (rank 0 alone when all caps are
    empty).

For IP the raw k-th inner-product score is turned into an angle with
acos(clip(score, -1, 1)), as in the JAX package (a documented deviation from
query_coordinator.cpp:557 with geometry.h:287).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

NUM_X_VALUES = 1001  # geometry.h:7
BETAINC_TERMS = 128  # continued-fraction terms of `betainc`, a fixed count
_F32_TINY = float(torch.finfo(torch.float32).tiny)  # the smallest normal float32


def _flush(v: torch.Tensor) -> torch.Tensor:
    """v with values below the smallest normal float32 (denormals, and
    anything negative) set to 0. XLA flushes float32 denormals to zero, so
    the JAX package's floors (max(v, 1e-38): 1e-38 is a denormal) and its
    products read them as 0; torch keeps them, and a profile of denormal
    masses would be normalized where the JAX package falls back to rank 0."""
    return torch.where(v >= _F32_TINY, v, torch.zeros_like(v))


def _betainc_lentz(a: float, b: float, x: float, iters: int = 500) -> float:
    """Host-side regularized incomplete beta via Lentz continued fractions —
    the reference's exact algorithm (geometry.h:115-161)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc_lentz(b, a, 1.0 - x, iters)
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    front = math.exp(math.log(x) * a + math.log1p(-x) * b - lbeta) / a
    f, c, d = 1.0, 1.0, 0.0
    tiny = 1e-30
    for i in range(iters):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = (m * (b - m) * x) / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -((a + m) * (a + b + m) * x) / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        if abs(d) < tiny:
            d = tiny
        d = 1.0 / d
        c = 1.0 + num / c
        if abs(c) < tiny:
            c = tiny
        f *= c * d
        if abs(1.0 - c * d) < 1e-8:
            break
    return front * (f - 1.0)


def betainc(a: float, b: float, x: torch.Tensor, terms: int = BETAINC_TERMS) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b) of every element of x (the
    counterpart of jax.scipy.special.betainc for scalar a, b > 0): the
    Lentz continued fraction of _betainc_lentz in float64 tensor operations,
    with the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) taken element by element
    where x > (a + 1) / (a + b + 2). It runs a fixed `terms` terms instead of
    stopping at convergence, so it never asks the device how far it got;
    past convergence a term multiplies f by 1. Returns x's dtype."""
    x64 = x.to(torch.float64)
    a_t = torch.full_like(x64, float(a))
    b_t = torch.full_like(x64, float(b))
    swap = x64 > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b_t, a_t), torch.where(swap, a_t, b_t)
    xx = torch.clamp(torch.where(swap, 1.0 - x64, x64), 1e-300, 1.0 - 1e-16)
    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    front = torch.exp(torch.log(xx) * aa + torch.log1p(-xx) * bb - lbeta) / aa
    tiny = 1e-30
    f = torch.ones_like(x64)
    c = torch.ones_like(x64)
    d = torch.zeros_like(x64)
    for i in range(terms):
        m = i // 2
        if i == 0:
            num = torch.ones_like(x64)
        elif i % 2 == 0:
            num = (m * (bb - m) * xx) / ((aa + 2 * m - 1) * (aa + 2 * m))
        else:
            num = -((aa + m) * (aa + bb + m) * xx) / ((aa + 2 * m) * (aa + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + num / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        f = f * c * d
    val = front * (f - 1.0)
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x64 <= 0.0, torch.zeros_like(val), val)
    val = torch.where(x64 >= 1.0, torch.ones_like(val), val)
    return val.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _beta_table_np(dimension: int, metric: str) -> np.ndarray:
    a = (dimension + 1.0) / 2.0 if metric == "l2" else (dimension - 1.0) / 2.0
    xs = [i / (NUM_X_VALUES - 1) for i in range(NUM_X_VALUES)]
    return np.array([_betainc_lentz(a, 0.5, x) for x in xs], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _beta_table_on(dimension: int, metric: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_beta_table_np(dimension, metric)).to(device)


def beta_table(dimension: int, metric: str = "l2", device="cpu") -> torch.Tensor:
    """Precomputed I_x(a, 1/2) on a 1001-point grid (geometry.h:163-179),
    computed on the host with Lentz (bit for bit the JAX package's table)
    and kept once per device, so a search copies nothing to the card. The
    cached tensor is shared: never write to it."""
    return _beta_table_on(int(dimension), metric, torch.device(device))


def beta_lookup(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Linear interpolation into the precomputed table (geometry.h:181-211)."""
    x = torch.clamp(x, 0.0, 1.0)
    scaled = x * (NUM_X_VALUES - 1)
    idx = torch.clamp(scaled.to(torch.int32), 0, NUM_X_VALUES - 2)
    frac = scaled - idx.to(scaled.dtype)
    idx = idx.long()
    y1 = table[idx]
    y2 = table[idx + 1]
    return y1 + frac * (y2 - y1)


def boundary_distances(q: torch.Tensor, cents: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distance from each query to the Voronoi bisector between its nearest
    centroid and each other candidate centroid (geometry.h:57-113).

    q: [B, D]; cents: [B, M, D] candidate centroids in rank order (rank 0 =
    nearest). Returns [B, M] f32; column 0 is a -1 placeholder."""
    c0 = cents[:, 0, :]
    if metric == "l2":
        r = (q - c0)[:, None, :]
        v = cents - c0[:, None, :]
        a2 = torch.sum(v * v, dim=2)
        a = torch.sqrt(torch.clamp(a2, min=1e-30))
        dot = torch.sum(r * v, dim=2)
        d = torch.abs(dot - 0.5 * a2) / a
    else:
        mid = 0.5 * (cents + c0[:, None, :])
        norm = torch.sqrt(torch.clamp(torch.sum(mid * mid, dim=2), min=1e-30))
        cosang = torch.sum(q[:, None, :] * mid, dim=2) / norm
        d = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    d = d.clone()
    d[:, 0] = -1.0
    return d


def log_cap_volume_ratio(radius: torch.Tensor, boundary: torch.Tensor, dimension: int,
                         metric: str = "l2", use_precomputed: bool = True,
                         table=None) -> torch.Tensor:
    """log of (cap volume / sphere volume) (geometry.h:247-295), batched.

    radius: [B] or [B, 1]; boundary: [B, M]. Returns [B, M] log-ratios."""
    R = radius if radius.ndim == 2 else radius[:, None]
    if metric == "l2":
        h = torch.minimum(torch.clamp(R - boundary, min=0.0), 2.0 * R)
        Rsafe = torch.clamp(R, min=1e-30)
        x = torch.sqrt(torch.clamp((2.0 * Rsafe * h - h * h) / (Rsafe * Rsafe), 0.0, 1.0))
        if use_precomputed:
            tbl = table if table is not None else beta_table(dimension, "l2", boundary.device)
            inc = beta_lookup(x, tbl)
        else:
            inc = betainc((dimension + 1.0) / 2.0, 0.5, x)
        return math.log(0.5) + torch.log(_flush(inc))
    # The difference form 0.5 [I(sin^2(R/2)) - I(sin^2(b/2))] the reference
    # documents at geometry.h:285 (see the JAX package's note).
    a = (dimension - 1.0) / 2.0
    sr = torch.sin(R / 2.0) ** 2
    sb = torch.sin(boundary / 2.0) ** 2
    i_r = betainc(a, 0.5, torch.clamp(sr, 0.0, 1.0))
    i_b = betainc(a, 0.5, torch.clamp(sb, 0.0, 1.0))
    return math.log(0.5) + torch.log(_flush(i_r - i_b))


def recall_profile(boundary: torch.Tensor, radius: torch.Tensor, dimension: int,
                   metric: str = "l2", use_precomputed: bool = True, table=None, valid=None,
                   gamma=None) -> torch.Tensor:
    """Per-partition probability that the true NN lies in each candidate
    partition (geometry.h:345-407), batched over queries.

    boundary: [B, M] (rank order, col 0 placeholder); radius: [B]; valid:
    optional [B, M] bool marking real (non-padded) candidates; gamma:
    optional sharpening exponent (p ^ gamma before normalization, a float).
    Returns probs [B, M] summing to 1 per query; all 0 where the radius is
    not finite (the top-k not full yet), so the caller keeps scanning; all
    mass on rank 0 where a finite ball crosses no bisector."""
    B, M = boundary.shape
    R = radius[:, None]
    logv = log_cap_volume_ratio(radius, boundary, dimension, metric, use_precomputed, table)
    zero = torch.zeros_like(logv)
    p = _flush(torch.exp(logv))
    p = torch.where(boundary < R, p, zero)
    if valid is not None:
        p = torch.where(valid, p, zero)
    finite_r = torch.isfinite(R) & (R > 0)
    p = torch.where(finite_r, p, zero)
    if gamma is not None:
        p = _flush(torch.pow(p, gamma))
    if M >= 2:  # the rank-0 heuristic needs a rank-1 column
        p = p.clone()
        p[:, 0] = 2.0 * p[:, 1]
    s = torch.sum(p, dim=1, keepdim=True)
    home = torch.zeros_like(p)
    home[:, 0] = 1.0
    fallback = torch.where(finite_r, home, zero)
    return torch.where(s > 0, p / torch.clamp(s, min=1e-38), fallback)


def effective_dimension(x, max_sample: int = 16384) -> int:
    """Participation-ratio intrinsic dimension: (sum lambda)^2 / sum lambda^2
    of the sample covariance spectrum (a numpy copy of the JAX package's).

    The cap-volume recall model's concentration depends exponentially on
    dimension; real corpora live on low-dimensional manifolds, so the
    ambient d overestimates recall. Isotropic data returns ~d; manifold data
    returns its intrinsic dimension. `QuakeIndex.build` stores it as
    `aps_dimension`."""
    x = np.asarray(x, dtype=np.float32)
    if x.shape[0] > max_sample:
        idx = np.random.default_rng(0).choice(x.shape[0], max_sample, replace=False)
        x = x[idx]
    xc = x - x.mean(axis=0, keepdims=True)
    cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    lam = np.linalg.eigvalsh(cov.astype(np.float64))
    lam = np.clip(lam, 0.0, None)
    s1, s2 = lam.sum(), (lam**2).sum()
    if s2 <= 0:
        return x.shape[1]
    d_eff = int(round(s1 * s1 / s2))
    return int(np.clip(d_eff, 2, x.shape[1]))


def estimate_overlap(new_centroid: torch.Tensor, old_centroid: torch.Tensor,
                     nbr_centroids: torch.Tensor) -> torch.Tensor:
    """Relative boundary shift toward each neighbor after a centroid moves
    (geometry.h:419-471). Used by maintenance refinement heuristics."""
    old_b = 0.5 * torch.linalg.norm(nbr_centroids - old_centroid[None, :], dim=1)
    new_b = 0.5 * torch.linalg.norm(nbr_centroids - new_centroid[None, :], dim=1)
    mean_old = torch.clamp(torch.mean(old_b), min=1e-30)
    return torch.abs(new_b - old_b) / mean_old
