"""Geometry helpers of the build (the part of quake_tpu/geometry.py that the
fixed-nprobe path needs; the recall-estimation math of APS is not ported
yet)."""

from __future__ import annotations

import numpy as np


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
