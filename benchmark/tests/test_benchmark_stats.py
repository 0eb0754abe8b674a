"""The statistics: a tail over all calls, rates over the whole window."""

import pytest

from benchmark import core, tracing
from benchmark.kinds import churn, search_batches


def test_percentile_is_nearest_rank_over_all_values():
    v = list(range(1, 101))
    assert core.percentile(v, 95) == 95
    assert core.percentile(v[::-1], 95) == 95
    assert core.percentile([3.0], 95) == 3.0
    assert core.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        core.percentile([], 95)


def test_search_rates_over_the_window(monkeypatch):
    run = search_batches.Run.__new__(search_batches.Run)
    run.traffic = {"batch": 100}
    run.attempted, run.elapsed = 40, 2.0
    run.readings = core.Readings(calls=[{"ms": float(i)} for i in range(1, 41)])
    run.Q = run.x = run.ans_ids = None
    run.k = 10
    monkeypatch.setattr(search_batches.reference, "exact_knn", lambda *a, **k: (None, None))
    monkeypatch.setattr(search_batches.reference, "recall", lambda *a: 0.5)
    e2e = run.end_to_end()
    assert e2e["qps"] == 40 * 100 / 2.0
    assert e2e["search_ms_p95"] == 38.0


def test_churn_rate_over_the_window(monkeypatch):
    run = churn.Run.__new__(churn.Run)
    run.attempted, run.elapsed, run.k = 30, 1.5, 10
    run._truth = run._ans = object()
    monkeypatch.setattr(churn.reference, "recall", lambda *a: 0.9)
    assert run.end_to_end()["churn_ops_per_s"] == 20.0


def test_layer_readers():
    ops = [{"type": "insert", "ms": 4.0, "maint_ms": 1.0}, {"type": "delete", "ms": 2.0, "maint_ms": 3.0},
           {"type": "query", "ms": 9.0, "maint_ms": 2.0}]
    r = core.Readings(ops=ops)
    assert core.metric_reader("api.write_ms.churn").read(r) == 3.0
    assert core.metric_reader("maint.ms.churn").read(r) == 2.0
    assert core.metric_reader("api.query_ms_p95.churn").read(r) == 9.0
    calls = [{"ms": 5.0, "buffer_init_ms": 1.0, "aggregate_ms": 0.5, "enqueue_ms": 2.0},
             {"ms": 7.0, "buffer_init_ms": 3.0, "aggregate_ms": 0.5, "enqueue_ms": 4.0}]
    r = core.Readings(calls=calls)
    assert core.metric_reader("api.copy_ms.search").read(r) == 2.5
    assert core.metric_reader("plan.dispatch_ms.search").read(r) == 3.0
    # Device metrics read nothing without a trace, and nothing is reported.
    for name in ("scan.k1_ms.search", "kernels.roofline_pct.search", "device.idle_pct.search"):
        assert core.metric_reader(name).read(r) is None
    r.trace = tracing.TraceSummary(window_s=2.0, busy_s=1.5, device_ops={"grouped_scan_mma_kernel": 1.0},
                                   n_device_events=3)
    r.traced_calls, r.bound_s = 4, 0.15
    assert core.metric_reader("scan.k1_ms.search").read(r) == 250.0
    assert core.metric_reader("kernels.roofline_pct.search").read(r) == pytest.approx(10.0)
    assert core.metric_reader("device.idle_pct.search").read(r) == pytest.approx(25.0)
    # One reader serves a quantity named apart by the metric it moves.
    assert core.metric_reader("device.idle_pct.churn").read(r) == pytest.approx(25.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_busy_ops_and_idle_gaps():
    events = [
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", "bench.search", 0, 60),
        _ev("user_annotation", "quake.dispatch", 5, 20),
        _ev("user_annotation", "bench.maintenance", 60, 40),
        _ev("kernel", "void grouped_scan_mma_kernel<float, 64>(Params)", 10, 30),
        _ev("kernel", "other", 30, 20),       # overlaps: busy is the union
        _ev("gpu_memcpy", "Memcpy HtoD", 70, 10),
        _ev("kernel", "outside", 200, 10),    # after the window: not counted
    ]
    s = tracing.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(50e-6)
    assert s.device_ops["grouped_scan_mma_kernel"] == pytest.approx(30e-6)
    assert "outside" not in s.device_ops
    # Gaps: [0,10) in quake.dispatch, [50,70) mid 60 in bench.maintenance,
    # [80,100) in bench.maintenance.
    assert s.idle_gaps["quake.dispatch"] == pytest.approx(10e-6)
    assert s.idle_gaps["bench.maintenance"] == pytest.approx(40e-6)
    b = s.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"} and len(b["device_ops"]) <= 10
