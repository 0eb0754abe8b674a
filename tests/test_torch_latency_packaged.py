"""The packaged latency grid of maintenance's cost model in the port against
the JAX package, on the CPU.

What is held, and how closely:
  * _apply_packaged_profile against the JAX package's on one and the same
    CSV (the JAX package's committed v5e grid, copied to a temporary
    directory that both packages' _packaged_profiles name) with the JAX
    package's share s = 0.55, at d = 128 and 960: the grids equal at rtol
    1e-6 and the provenance strings equal (tests/test_maintenance.py::
    test_packaged_grid_provenance_and_d_scaling's law);
  * the committed H100 grids (quake_tpu_torch/data, written by
    scripts/measure_latency_grid.py): they load in both packages, are
    positive, non-decreasing in n and k after the projection, and their
    sidecars name the card and its power limit; packaged=True at d = 128
    reads packaged(d=128,scale=1.000), and another d takes each point
    affine in d through the two grids (packaged(d=128..768,at=d));
  * the default (packaged=None): the analytic model for no device and for
    the CPU, the packaged grid for a CUDA device; a CPU index's policy reads
    "analytic", a CUDA-device index's (the device check monkeypatched, the
    index on the CPU) reads packaged(d=128,scale=1.000) after build and
    after load; an explicit profile or a loaded latency_profile.csv
    overrides it.
"""

import json
import os
import shutil

import numpy as np
import pytest

from quake_tpu.maintenance.latency_estimator import ListScanLatencyEstimator as JaxLatency
from quake_tpu_torch import IndexBuildParams, QuakeIndex
from quake_tpu_torch.maintenance import latency_estimator as lat
from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator, monotone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = os.path.join(REPO, "quake_tpu", "data", "v5e_grouped_latency_d128.csv")
H100_DS = (128, 768)


@pytest.mark.parametrize("d", [128, 960])
def test_apply_packaged_profile_equals_jax(tmp_path, monkeypatch, d):
    path = str(tmp_path / "v5e_grouped_latency_d128.csv")
    shutil.copy(V5E, path)
    monkeypatch.setattr(JaxLatency, "_packaged_profiles", classmethod(lambda cls: {128: path}))
    monkeypatch.setattr(ListScanLatencyEstimator, "_packaged_profiles",
                        classmethod(lambda cls: {128: path}))
    want = JaxLatency(d, packaged=True)
    got = ListScanLatencyEstimator(d, packaged=False)
    got._apply_packaged_profile(share=0.55)
    assert got.grid_source == want.grid_source
    assert want.grid_source == ("packaged(d=128,scale=1.000)" if d == 128
                                else "packaged(d=128,scale=4.575)")
    np.testing.assert_allclose(got.latency_grid, want.latency_grid, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", H100_DS)
def test_committed_h100_grids(d):
    base = os.path.join(lat.DATA_DIR, f"h100_grouped_latency_d{d}")
    assert os.path.exists(base + ".csv") and os.path.exists(base + ".json")
    ours, theirs = ListScanLatencyEstimator.from_csv(base + ".csv"), JaxLatency.from_csv(base + ".csv")
    np.testing.assert_array_equal(ours.latency_grid, theirs.latency_grid)
    assert ours.d == d and ours.n_values == lat.DEFAULT_LATENCY_ESTIMATOR_RANGE_N
    assert ours.k_values == lat.DEFAULT_LATENCY_ESTIMATOR_RANGE_K
    assert np.isfinite(ours.latency_grid).all() and (ours.latency_grid > 0).all()
    proj = monotone(ours.latency_grid)
    assert (np.diff(proj, axis=0) >= 0).all() and (np.diff(proj, axis=1) >= 0).all()
    with open(base + ".json") as f:
        meta = json.load(f)
    assert "H100" in meta["card"] and " W" in meta["card"] and meta["d"] == d
    assert meta["command"].startswith("python3 scripts/measure_latency_grid.py")
    est = ListScanLatencyEstimator(d, packaged=True)
    assert est.grid_source == f"packaged(d={d},scale=1.000)"
    np.testing.assert_allclose(est.latency_grid, proj, rtol=1e-12)


def test_nearest_grid_and_fitted_share():
    """A d without a grid of its own: each point affine in d through the two
    committed grids (the share measured point by point), within them and
    beyond; the grids stay monotone. share= keeps the JAX package's law."""
    g = {d: monotone(ListScanLatencyEstimator.from_csv(
        os.path.join(lat.DATA_DIR, f"h100_grouped_latency_d{d}.csv")).latency_grid) for d in H100_DS}
    for d in (64, 200, 448, 960):
        est = ListScanLatencyEstimator(d, packaged=True)
        assert est.grid_source == f"packaged(d=128..768,at={d})"
        want = monotone(g[128] + (d - 128) / 640.0 * (g[768] - g[128]))
        np.testing.assert_allclose(est.latency_grid, want, rtol=1e-9)
        assert (np.diff(est.latency_grid, axis=0) >= 0).all()
        assert (np.diff(est.latency_grid, axis=1) >= 0).all()
    mid = ListScanLatencyEstimator(448, packaged=True).latency_grid
    np.testing.assert_allclose(mid, monotone((g[128] + g[768]) / 2.0), rtol=1e-9)
    law = ListScanLatencyEstimator(960, packaged=False)
    law._apply_packaged_profile(share=0.55)
    assert law.grid_source == "packaged(d=768,scale=1.137)"
    np.testing.assert_allclose(law.latency_grid, g[768] * 1.1375, rtol=1e-9)


def test_default_follows_the_device():
    assert ListScanLatencyEstimator(128).grid_source == "analytic"
    assert ListScanLatencyEstimator(128, device="cpu").grid_source == "analytic"
    assert ListScanLatencyEstimator(128, device="cuda").grid_source == "packaged(d=128,scale=1.000)"
    assert ListScanLatencyEstimator(128, device="cuda", packaged=False).grid_source == "analytic"


def _index(tmp_path, d=128, **kw):
    x = np.random.default_rng(4).standard_normal((2000, d)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=8, calibrate_aps=False, **kw))
    path = str(tmp_path / "idx")
    idx.save(path)
    return idx, path


def _grid(idx):
    return idx.maintenance_policy.cost_estimator.latency_estimator.grid_source


def test_cpu_index_reads_analytic(tmp_path):
    idx, path = _index(tmp_path)
    assert _grid(idx) == "analytic"
    assert _grid(QuakeIndex(device="cpu").load(path)) == "analytic"


def test_cuda_index_reads_packaged(tmp_path, monkeypatch):
    """What a CUDA index's build and load set: the device check made to say
    CUDA for the CPU index's device. The mid level of a three-level index
    reads the grid as well; a profiled grid and its saved CSV override."""
    monkeypatch.setattr(ListScanLatencyEstimator, "_device_is_cuda", staticmethod(lambda dev: True))
    idx, path = _index(tmp_path, parent_params=IndexBuildParams(nlist=2))
    assert _grid(idx) == _grid(idx.parent) == "packaged(d=128,scale=1.000)"
    loaded = QuakeIndex(device="cpu").load(path)
    assert _grid(loaded) == _grid(loaded.parent) == "packaged(d=128,scale=1.000)"
    monkeypatch.setattr(lat, "DEFAULT_LATENCY_ESTIMATOR_RANGE_N", [64, 256])
    monkeypatch.setattr(lat, "DEFAULT_LATENCY_ESTIMATOR_RANGE_K", [1, 8])
    prof, ppath = _index(tmp_path / "p", d=16, profile_maintenance_latency=True)
    assert _grid(prof) == "profiled"
    assert _grid(QuakeIndex(device="cpu").load(ppath)) == "csv"
