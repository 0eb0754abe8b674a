"""quake_tpu_torch.geometry (the APS recall model) against quake_tpu.geometry
on the CPU: the same numpy inputs through both.

Tolerances: the beta table is computed on the host by the same Lentz code in
both packages, so it must be equal bit for bit. The torch `betainc` (a fixed
128-term continued fraction in float64) is held within 1e-5 absolute of
`_betainc_lentz` (the reference's algorithm, float64) everywhere, and of
jax.scipy.special.betainc (float32) where that one is itself within 1e-5 of
Lentz (a <= 64.5, the model dimensions up to 128; above that JAX's float32
evaluation drifts up to 2.4e-4 from Lentz, and the port is held to Lentz).
The rest is float32 arithmetic in another order: rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import betainc as jax_betainc

from quake_tpu import geometry as jg
from quake_tpu_torch import geometry as tg

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dimension", [2, 16, 33, 128])
def test_beta_table_equals_jax_bit_for_bit(dimension, metric):
    got = tg.beta_table(dimension, metric).numpy()
    want = np.asarray(jg.beta_table(dimension, metric))
    assert got.dtype == np.float32 and got.shape == (tg.NUM_X_VALUES,)
    np.testing.assert_array_equal(got, want)
    assert tg.beta_table(dimension, metric) is tg.beta_table(dimension, metric)  # cached


@pytest.mark.parametrize("a", [0.5, 1.0, 4.5, 16.5, 64.5, 127.5, 512.5])
def test_betainc_against_lentz_and_jax(a):
    rng = np.random.default_rng(int(a * 2))
    xs = np.concatenate([np.linspace(0.0, 1.0, 1001), rng.uniform(0, 1, 500),
                         [1e-7, 1.0 - 1e-7, (a + 1.0) / (a + 2.5)]]).astype(np.float32)
    got = tg.betainc(a, 0.5, _t(xs)).numpy()
    assert got.dtype == np.float32
    lentz = np.array([tg._betainc_lentz(a, 0.5, float(x)) for x in xs])
    assert np.abs(got - lentz).max() <= 1e-5
    if a <= 64.5:
        want = np.asarray(jax_betainc(jnp.float32(a), jnp.float32(0.5), jnp.asarray(xs)))
        assert np.abs(got - want).max() <= 1e-5


def test_beta_lookup_matches():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 2000), [0.0, 1.0, 0.5, 0.999]]).astype(np.float32)
    table = tg.beta_table(24, "l2")
    _close(tg.beta_lookup(_t(x), table), jg.beta_lookup(jnp.asarray(x), jg.beta_table(24, "l2")))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_boundary_distances_match(metric):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((9, 12)).astype(np.float32)
    cents = rng.standard_normal((9, 7, 12)).astype(np.float32)
    if metric == "ip":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        cents /= np.linalg.norm(cents, axis=2, keepdims=True)
    got = tg.boundary_distances(_t(q), _t(cents), metric)
    want = jg.boundary_distances(jnp.asarray(q), jnp.asarray(cents), metric)
    _close(got, want)
    assert (got[:, 0] == -1.0).all()


def _radii_and_boundaries(seed, B=6, M=9, metric="l2"):
    rng = np.random.default_rng(seed)
    hi = 3.0 if metric == "l2" else np.pi
    boundary = np.sort(rng.uniform(0.05, hi, (B, M)).astype(np.float32), axis=1)
    boundary[:, 0] = -1.0
    radius = rng.uniform(0.1, hi, B).astype(np.float32)
    return boundary, radius


@pytest.mark.parametrize("use_precomputed", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_log_cap_volume_ratio_matches(metric, use_precomputed):
    boundary, radius = _radii_and_boundaries(3, metric=metric)
    for dim in (8, 32):
        got = tg.log_cap_volume_ratio(_t(radius), _t(boundary), dim, metric, use_precomputed)
        want = jg.log_cap_volume_ratio(jnp.asarray(radius), jnp.asarray(boundary), dim, metric,
                                       use_precomputed)
        _close(got, want)
        # [B, 1] radii give the same.
        _close(tg.log_cap_volume_ratio(_t(radius[:, None]), _t(boundary), dim, metric,
                                       use_precomputed), want)


@pytest.mark.parametrize("case", ["plain", "valid", "gamma", "infinite", "one_column",
                                  "uncached_table", "all_caps_empty"])
def test_recall_profile_matches(case):
    boundary, radius = _radii_and_boundaries(4, B=8, M=10)
    kw_t, kw_j = {}, {}
    dim, use_pre = 20, True
    if case == "valid":
        valid = np.random.default_rng(5).uniform(size=boundary.shape) > 0.3
        valid[:, 0] = True
        kw_t["valid"], kw_j["valid"] = _t(valid), jnp.asarray(valid)
    elif case == "gamma":
        kw_t["gamma"], kw_j["gamma"] = 3.0, jnp.float32(3.0)
    elif case == "infinite":
        radius[::2] = np.inf
    elif case == "one_column":
        boundary, radius = boundary[:, :1], radius
    elif case == "uncached_table":
        use_pre = False
    elif case == "all_caps_empty":
        radius[:] = 0.01  # inside every bisector: all mass on rank 0
    got = tg.recall_profile(_t(boundary), _t(radius), dim, "l2", use_pre, **kw_t)
    want = jg.recall_profile(jnp.asarray(boundary), jnp.asarray(radius), dim, "l2", use_pre,
                             **kw_j)
    _close(got, want)
    got = got.numpy()
    fin = np.isfinite(radius)
    np.testing.assert_allclose(got[fin].sum(axis=1), 1.0, rtol=1e-5)
    assert (got[~fin] == 0).all()
    if case == "all_caps_empty":
        assert (got[:, 0] == 1.0).all()


def test_recall_profile_with_a_passed_table():
    boundary, radius = _radii_and_boundaries(6)
    got = tg.recall_profile(_t(boundary), _t(radius), 5, "l2", True, table=tg.beta_table(40))
    want = jg.recall_profile(jnp.asarray(boundary), jnp.asarray(radius), 5, "l2", True,
                             table=jg.beta_table(40))
    _close(got, want)


def test_estimate_overlap_matches():
    rng = np.random.default_rng(7)
    new, old = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    nbrs = rng.standard_normal((11, 6)).astype(np.float32)
    _close(tg.estimate_overlap(_t(new), _t(old), _t(nbrs)),
           jg.estimate_overlap(jnp.asarray(new), jnp.asarray(old), jnp.asarray(nbrs)))
