"""The inner-product cell cut down to a CPU size (20,000 unit vectors x 96,
nlist 256, batches of 256, 128 rows of each call judged): its corpus, its
judge on the program's outputs, and the faults the ip reference catches:
scores in TF32 (`ip_err`), a selection by fp8 products (`sel_budget`), a
plan's profile in bfloat16 (`plan_gap`) and a scan that drops each query's
first partition."""

import dataclasses
import time

import pytest
import torch

import quake_tpu_torch.coordinator as coordinator
import quake_tpu_torch.timing as timing
from benchmark import core, reference_ip
from benchmark.run import run_cell

CELL = "deep10m-ip-bf16.oneshot16k-ip"
SEED = 2**31 + 4242


def _cut():
    spec = core.load_spec()
    w = core.workload(spec, CELL)
    cfg = core.config(spec, w["config"])
    tr = core.traffic(w["traffic"])
    cfg["n"] = 20000
    cfg["build"].update(nlist=256, niter=4)
    # Half of every batch sampled: the maxima the controls are judged by do
    # not hang on how many calls a loaded machine fits in the window.
    tr.update(batch=256, pool_batches=2, warmup_rounds=1, trace_seconds=0.3,
              sample_rows_per_call=128)
    return spec, cfg, tr, core.limits(CELL)


@pytest.fixture(scope="module")
def judged():
    """One cut-down run, its window over, judged: (run, the program's
    numbers, the limits)."""
    _, cfg, tr, lims = _cut()
    run = core.kind(tr["kind"]).Run(cfg, tr, SEED, torch.device("cpu"))
    run.setup()
    run.window(0.5)
    run.collect()
    return run, run.numbers(), lims


def test_corpus_is_unit_norm_and_made_again_from_the_seed(judged):
    run, _, _ = judged
    x = run._corpus()
    assert x.shape == (20000, 96) and x.dtype == torch.float32
    torch.testing.assert_close(torch.linalg.vector_norm(x.double(), dim=1),
                               torch.ones(20000, dtype=torch.float64), rtol=0, atol=1e-6)
    assert torch.equal(x, run.x)  # collect made it again, bit for bit
    q = run._queries()
    assert all(torch.equal(a, b) for a, b in zip(q, run.q))
    assert all(torch.equal(torch.from_numpy(a), b) for a, b in zip(run.q_np, q))
    assert not torch.equal(q[0], q[1])


def test_program_reads_correct(judged):
    run, numbers, lims = judged
    ok, checks = core.judge(numbers, lims)
    assert ok, checks
    assert set(lims) == {"ip_err", "sel_budget", "norm_err", "invalid", "store_err",
                         "plan_gap", "recall_short"}
    build = run.readings.build
    assert build["balance_time_us"] <= build["train_time_us"]
    assert build["calibrate_time_us"] > 0


def test_tf32_scores_are_not_correct(judged):
    """The reference's top-k in the program's place, its scores in TF32:
    `ip_err` leaves its limit."""
    run, _, lims = judged
    ids, scores = reference_ip.exact_topk(run.Q, run.stored, run.k, precision="tf32")
    err = reference_ip.ip_err(run.Q, run.stored, ids, scores)
    assert err > lims["ip_err"], err


def test_fp8_selection_is_not_correct(judged):
    """K1's ip key selection with its products in fp8: `sel_budget` leaves
    its limit; the control (the reference in fp8) fails the cell."""
    run, _, lims = judged
    assert run.keyed_numbers("fp8")["sel_budget"] > lims["sel_budget"]
    ok, checks = core.judge(run.numbers("fp8"), lims)
    assert not ok, checks


def test_bf16_profile_is_not_correct(judged):
    run, _, lims = judged
    assert run.numbers("fp8")["plan_gap"] > lims["plan_gap"]


def test_traced_run_reads_the_build_and_search_metrics():
    spec, cfg, tr, lims = _cut()
    res, checks, lines = run_cell(CELL, SEED, 0.3, True, torch.device("cpu"), time.perf_counter(),
                                  spec=spec, cfg=cfg, traffic=tr, lims=lims)
    assert res["correct"], checks
    m = res["metrics"]
    for name in ("build.kmeans_ms.setup", "build.balance_ms.setup", "build.calibrate_ms.setup",
                 "aps.setup_ms.oneshot", "aps.plan_ms.oneshot", "aps.depth.oneshot",
                 "plan.parent_ms.search", "plan.grouping_ms.search", "api.copy_ms.search"):
        assert name in m, name
    assert m["build.calibrate_ms.setup"]["value"] > 0
    assert any(line.startswith("build: ") for line in lines)
    # No device events in a CPU trace: the device metrics give nothing.
    for name in ("scan.k1_ms.search", "kernels.roofline_pct.search", "device.idle_pct.search"):
        assert name not in m, name


def test_dropped_partition_is_not_correct(monkeypatch):
    """The oneshot scan skips each query's first ranked partition, which
    every sound ranking probes: the selection falls outside its budget."""
    real_fused, real_scan = coordinator.aps_search_oneshot_fused, coordinator._budgeted_scan

    def dropping(*a, **kw):
        scan = real_scan(*a, **kw)

        def drop_first(eff, pair_budget=0):
            eff = eff.clone()
            eff[:, 0] = -1
            return scan(eff, pair_budget)
        return drop_first

    def fused(*a, **kw):
        with monkeypatch.context() as m:
            m.setattr(coordinator, "_budgeted_scan", dropping)
            return real_fused(*a, **kw)

    monkeypatch.setattr(coordinator, "aps_search_oneshot_fused", fused)
    spec, cfg, tr, lims = _cut()
    res, checks, _ = run_cell(CELL, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                              spec=spec, cfg=cfg, traffic=tr, lims=lims)
    assert not res["correct"]
    assert checks["sel_budget"]["value"] > checks["sel_budget"]["limit"], checks


def test_a_program_without_build_counters_stops_before_building(monkeypatch):
    """The parent commit's BuildTimingInfo has no balance_time_us: the
    kind raises at once, before any data or build."""
    @dataclasses.dataclass
    class OldBuildTimingInfo:
        n_vectors: int = 0
        train_time_us: int = 0
        assign_time_us: int = 0
        total_time_us: int = 0

    monkeypatch.setattr(timing, "BuildTimingInfo", OldBuildTimingInfo)
    _, cfg, tr, _ = _cut()
    with pytest.raises(RuntimeError, match="balance_time_us"):
        core.kind(tr["kind"]).Run(cfg, tr, SEED, torch.device("cpu"))
