"""The recall-target cell cut down to a CPU size (20,000 vectors, nlist 256,
batches of 256): the program reads correct, and the checks of the kind
`aps_batches` catch a scan that drops each query's nearest partition
(`sel_budget`), a plan one rounding step shallower (`plan_gap`) and a radius
predictor the build fitted too short (`recall_short`)."""

import time

import torch

import quake_tpu_torch.coordinator as coordinator
from benchmark import core
from quake_tpu_torch import QuakeIndex
from benchmark.run import run_cell

CELL = "sift1m-f32-nl1024-aps.oneshot4k"


def _cut():
    spec = core.load_spec()
    w = core.workload(spec, CELL)
    cfg = core.config(spec, w["config"])
    tr = core.traffic(w["traffic"])
    cfg["n"] = 20000
    cfg["build"].update(nlist=256, niter=4)
    tr.update(batch=256, pool_batches=2, warmup_rounds=1, trace_seconds=0.3)
    return spec, cfg, tr, core.limits(CELL)


def _run(trace: bool = False):
    spec, cfg, tr, lims = _cut()
    return run_cell(CELL, 2**31 + 12345, 0.5, trace, torch.device("cpu"), time.perf_counter(),
                    spec=spec, cfg=cfg, traffic=tr, lims=lims)


def test_cut_down_cell_reads_correct():
    res, checks, lines = _run(trace=True)
    assert res["correct"], checks
    assert set(checks) == {"dist_err", "sel_budget", "norm_err", "invalid", "store_err",
                           "plan_gap", "recall_short"}
    m = res["metrics"]
    for name in ("aps.setup_ms.oneshot", "aps.plan_ms.oneshot", "aps.launches.oneshot",
                 "aps.depth.oneshot"):
        assert name in m, name
    assert 4 <= m["aps.depth.oneshot"]["value"] <= 64
    # No device events in a CPU trace: the device metrics give nothing.
    for name in ("scan.k1_ms.search", "kernels.roofline_pct.search", "device.idle_pct.search"):
        assert name not in m, name
    assert any(line.startswith("aps state: ") for line in lines)


def _serving(monkeypatch, name, fake):
    """Replace coordinator.`name` by `fake` inside the fused oneshot search
    alone, the serving path, so that the build's calibration runs as it is."""
    real = coordinator.aps_search_oneshot_fused

    def fused(*a, **kw):
        with monkeypatch.context() as m:
            m.setattr(coordinator, name, fake)
            return real(*a, **kw)
    monkeypatch.setattr(coordinator, "aps_search_oneshot_fused", fused)


def test_dropped_partition_is_not_correct(monkeypatch):
    """The oneshot scan skips each query's nearest partition, which every
    sound ranking probes: the selection falls outside its budget."""
    real = coordinator._budgeted_scan

    def dropping(*a, **kw):
        scan = real(*a, **kw)

        def drop_first(eff, pair_budget=0):
            eff = eff.clone()
            eff[:, 0] = -1
            return scan(eff, pair_budget)
        return drop_first

    _serving(monkeypatch, "_budgeted_scan", dropping)
    res, checks, _ = _run()
    assert not res["correct"]
    assert checks["sel_budget"]["value"] > checks["sel_budget"]["limit"], checks


def test_shallower_plan_is_not_correct(monkeypatch):
    """Every plan one rounding step shallower: the depths leave the
    reference's on most rows."""
    real = coordinator._plan_depth
    _serving(monkeypatch, "_plan_depth",
             lambda probs, target: torch.clamp(real(probs, target) - 4, min=1))
    res, checks, _ = _run()
    assert not res["correct"]
    assert checks["plan_gap"]["value"] > checks["plan_gap"]["limit"], checks


def test_miscalibrated_radius_predictor_is_not_correct(monkeypatch):
    """The build fits a radius predictor that predicts the control's
    share (MISCALIBRATION) of the radius it should: the program and the
    plan's reference both plan from it, so the depths agree, and only the
    answers' recall against the exact neighbours falls short of the target."""
    real = QuakeIndex._calibrate_radius_predictor
    share = core.kind("aps_batches").MISCALIBRATION

    def short(self, *a, **kw):
        real(self, *a, **kw)
        if self.aps_radius_ab is not None:
            self.aps_radius_ab *= share
    monkeypatch.setattr(QuakeIndex, "_calibrate_radius_predictor", short)
    res, checks, _ = _run()
    assert not res["correct"]
    assert checks["plan_gap"]["value"] <= checks["plan_gap"]["limit"], checks
    assert checks["recall_short"]["value"] > checks["recall_short"]["limit"], checks
