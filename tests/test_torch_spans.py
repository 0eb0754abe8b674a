"""The port's spans and their table on the CPU (quake_tpu_torch/profiling.py):
the spans that search, add, remove and maintenance open under device_trace,
no record_function without a profiler, and span_table on a hand-written
Chrome trace (two threads, nested spans, kernels joined to their launches
by correlation ids, one cudaStreamSynchronize)."""

import json

import numpy as np
import pytest
import torch

from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
from quake_tpu_torch.params import MaintenancePolicyParams
from quake_tpu_torch.profiling import (LAUNCH_CALLS, SPANS_FILE, SYNC_CALLS, annotate,
                                       call_kind, device_trace, last_spans, span_table)

N, D, NLIST = 2000, 16, 8
SEARCH_SPANS = ("quake.search", "quake.buffer_init", "quake.dispatch", "quake.device_wait",
                "quake.aggregate", "quake.plan.parent", "quake.plan.grouping", "quake.scan",
                "quake.plan.placement", "quake.plan.merge", "quake.plan.rescore",
                "quake.plan.distances", "quake.plan.hits")


def _index(window: int = 16, **policy) -> tuple:
    x = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, np.arange(N, dtype=np.int64), IndexBuildParams(nlist=NLIST, calibrate_aps=False))
    idx.initialize_maintenance_policy(MaintenancePolicyParams(window_size=window, **policy))
    return idx, x


def _sound(table: dict) -> None:
    for name, row in table.items():
        assert set(row) == {"calls", "host_ms", "self_ms", "launches", "syncs", "device_ms"}
        assert 0.0 <= row["self_ms"] <= row["host_ms"] + 1e-9, name
        assert row["launches"] == row["syncs"] == 0 and row["device_ms"] == 0.0, name


def test_search_add_remove_spans(tmp_path):
    """Three fused searches, two adds and a remove: every span of their
    paths, one call each time the path passes it."""
    idx, x = _index()
    sp = SearchParams(k=5, nprobe=3)
    with device_trace(str(tmp_path)):
        for i in range(3):
            idx.search(x[32 * i:32 * (i + 1)], sp)
        idx.add(x[:40] + 0.01, np.arange(N, N + 40))
        idx.add(x[40:60] + 0.01, np.arange(N + 40, N + 60))
        idx.remove(np.arange(N, N + 30))
    table = last_spans()
    assert json.loads((tmp_path / SPANS_FILE).read_text()) == table
    _sound(table)
    for name in SEARCH_SPANS:
        assert table[name]["calls"] == 3, name
    for name in ("quake.add", "quake.add.validate", "quake.add.assign", "quake.store.append"):
        assert table[name]["calls"] == 2, name
    for name in ("quake.remove", "quake.store.remove"):
        assert table[name]["calls"] == 1, name
    # The four phases nest in quake.search, the plan's stages in quake.dispatch.
    phases = sum(table[n]["host_ms"] for n in SEARCH_SPANS[1:5])
    assert table["quake.search"]["self_ms"] == pytest.approx(
        table["quake.search"]["host_ms"] - phases, abs=1e-6)
    assert table["quake.dispatch"]["self_ms"] < table["quake.dispatch"]["host_ms"]


@pytest.mark.parametrize("policy, span", [
    (dict(split_threshold_ns=-1e30, delete_threshold_ns=1e30), "quake.maint.split"),
    (dict(split_threshold_ns=1e30, delete_threshold_ns=-1e30), "quake.maint.delete"),
])
def test_maintenance_spans(tmp_path, policy, span):
    """maintenance() with a full window: the window, the decision, the
    forced splits (then refinement) or deletes, the invalidation; the
    rewritten partitions leave and enter the parent through its own remove
    and add, and the store grows."""
    idx, x = _index(window=16, **policy)
    idx.search(x[:32], SearchParams(k=5, nprobe=3))
    with device_trace(str(tmp_path)):
        mt = idx.maintenance()
    table = last_spans()
    _sound(table)
    assert mt.n_splits if span == "quake.maint.split" else mt.n_deletes
    for name in ("quake.maintenance", "quake.maint.window", "quake.maint.decide",
                 "quake.maint.invalidate", span):
        assert table[name]["calls"] == 1, name
    assert table["quake.remove"]["calls"] >= 1  # the parent's
    assert table["quake.add"]["calls"] >= 1
    if span == "quake.maint.split":
        assert table["quake.maint.refine"]["calls"] == 1
    else:  # the orphans go into the one partition left, which grows
        assert table["quake.store.grow"]["calls"] >= 1
    # The stages follow one another; quake.maint.reject nests in .decide.
    inner = sum(r["host_ms"] for n, r in table.items()
                if n.startswith("quake.maint.") and n != "quake.maint.reject")
    assert inner <= table["quake.maintenance"]["host_ms"] + 1e-6
    if "quake.maint.reject" in table:
        assert (table["quake.maint.reject"]["host_ms"]
                <= table["quake.maint.decide"]["host_ms"] + 1e-6)


def test_store_growth_span(tmp_path):
    idx, _ = _index()
    store = idx.store
    C = store.C
    with device_trace(str(tmp_path)):
        store.ensure_capacity(np.full(store.P, C, dtype=np.int64))
        store.ensure_rows(len(store.free_rows) + 1)
    assert store.C > C
    assert last_spans()["quake.store.grow"]["calls"] == 2


def test_sharded_search_spans(tmp_path):
    idx, x = _index()
    idx.shard(2)
    with device_trace(str(tmp_path)):
        idx.search(x[:32], SearchParams(k=5, nprobe=3))
    table = last_spans()
    for name in ("quake.plan.parent", "quake.plan.shard_merge", "quake.plan.distances"):
        assert table[name]["calls"] == 1, name
    assert table["quake.scan"]["calls"] == 2  # one a shard


def _aps_index() -> tuple:
    """An IVF index with a recall model set by hand (radius 0.5 + d1, a
    candidate width of 6, the plans clipped to 6 and budgeted at 4 a query),
    so that oneshot search plans, clips and budgets without a calibration."""
    idx, x = _index()
    idx.aps_radius_ab = np.tile(np.array([[0.5, 1.0]], np.float32), (16, 1))
    idx.aps_oneshot_mcap = idx.aps_plan_width = 6
    idx.aps_width_clip, idx.aps_budget_w = 6, 4
    return idx, x


APS_SPANS = {"oneshot": ("quake.plan.parent", "quake.aps.setup", "quake.aps.plan"),
             "planned": ("quake.aps.setup", "quake.aps.plan")}


@pytest.mark.parametrize("mode", ["oneshot", "planned"])
def test_aps_spans_nest_in_dispatch(tmp_path, mode):
    """Two recall-target searches: the APS spans open once a search (the
    fused oneshot ranks its parents in quake.plan.parent), each inside a
    quake.dispatch on the same thread."""
    idx, x = _aps_index()
    sp = SearchParams(k=5, recall_target=0.9, aps_mode=mode)
    with device_trace(str(tmp_path)):
        for i in range(2):
            idx.search(x[32 * i:32 * (i + 1)], sp)
    table = last_spans()
    _sound(table)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    dispatch = [e for e in spans if e["name"] == "quake.dispatch"]
    assert len(dispatch) == 2
    for name in APS_SPANS[mode]:
        assert table[name]["calls"] == 2, name
        for e in (e for e in spans if e["name"] == name):
            assert any(d["tid"] == e["tid"] and d["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= d["ts"] + d["dur"] for d in dispatch), name


@pytest.mark.parametrize("mode", ["oneshot", "planned"])
def test_aps_depth_counters(mode):
    """scanned_per_query: each query's scanned partitions, int32 [B], whose
    mean truncates to partitions_scanned; aps_pair_budget: B times the
    budget a query, the budget the plan passed to the scan."""
    idx, x = _aps_index()
    res = idx.search(x[:40], SearchParams(k=5, recall_target=0.9, aps_mode=mode))
    t = res.timing_info
    assert t.scanned_per_query.dtype == np.int32 and t.scanned_per_query.shape == (40,)
    assert int(t.scanned_per_query.mean()) == t.partitions_scanned
    assert 1 <= t.scanned_per_query.min() and t.scanned_per_query.max() <= NLIST
    assert t.aps_pair_budget == 40 * 4
    fixed = idx.search(x[:40], SearchParams(k=5, nprobe=3)).timing_info
    assert fixed.scanned_per_query is None and fixed.aps_pair_budget == 0


@pytest.mark.parametrize("mode", ["oneshot", "planned"])
def test_aps_answers_equal_with_and_without_tracing(tmp_path, mode):
    idx, x = _aps_index()
    sp = SearchParams(k=5, recall_target=0.9, aps_mode=mode)
    off = idx.search(x[:48], sp)
    with device_trace(str(tmp_path)):
        on = idx.search(x[:48], sp)
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_array_equal(on.distances, off.distances)
    np.testing.assert_array_equal(on.timing_info.scanned_per_query,
                                  off.timing_info.scanned_per_query)


BUILD_STAGES = ("quake.build.kmeans", "quake.build.balance", "quake.build.fill",
                "quake.build.parent", "quake.build.calibrate")


def test_build_spans_and_counters(tmp_path):
    """A traced build with calibration: quake.build and its five stages
    once each (the parent's own build opens none), the stages inside
    quake.build, and the build's timing counters filled: the balancing's
    share of train_time_us and the calibration's time."""
    x = np.random.default_rng(4).standard_normal((10000, 8)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    with device_trace(str(tmp_path)):
        t = idx.build(x, None, IndexBuildParams(nlist=16, niter=4))
    table = last_spans()
    _sound(table)
    assert table["quake.build"]["calls"] == 1
    for name in BUILD_STAGES:
        assert table[name]["calls"] == 1, name
    stages = sum(table[n]["host_ms"] for n in BUILD_STAGES)
    assert stages <= table["quake.build"]["host_ms"] + 1e-6
    assert table["quake.build"]["self_ms"] == pytest.approx(
        table["quake.build"]["host_ms"] - stages, abs=1e-6)
    assert idx.aps_radius_ab is not None
    assert 0 < t.balance_time_us <= t.train_time_us
    assert 0 < t.calibrate_time_us < t.total_time_us
    assert t.train_time_us + t.assign_time_us + t.calibrate_time_us <= t.total_time_us


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, a span is a shared no-op: search, add,
    remove and maintenance never reach record_function."""
    idx, x = _index(window=16, split_threshold_ns=-1e30)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert annotate("quake.a") is annotate("quake.b")
    idx.search(x[:32], SearchParams(k=5, nprobe=3))
    idx.add(x[:20] + 0.01, np.arange(N, N + 20))
    idx.remove(np.arange(N, N + 10))
    assert idx.maintenance().n_splits > 0


def test_call_sets_pinned():
    assert LAUNCH_CALLS == {
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
        "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemcpy3DAsync",
        "cudaMemcpyPeerAsync", "cudaMemcpyToSymbolAsync", "cudaMemcpyFromSymbolAsync",
        "cudaMemset", "cudaMemsetAsync", "cudaMemset2DAsync", "cudaMemset3DAsync",
        "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel", "cuGraphLaunch",
        "cuMemcpyAsync", "cuMemcpyHtoDAsync", "cuMemcpyDtoHAsync", "cuMemcpyDtoDAsync",
        "cuMemsetD8Async", "cuMemsetD16Async", "cuMemsetD32Async"}
    assert SYNC_CALLS == {
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
        "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyPeer", "cudaMemcpyToSymbol",
        "cudaMemcpyFromSymbol", "cuStreamSynchronize", "cuCtxSynchronize",
        "cuEventSynchronize", "cuMemcpy", "cuMemcpyHtoD", "cuMemcpyDtoH", "cuMemcpyDtoD"}
    assert call_kind("cudaLaunchKernelExC") == "launches"
    assert call_kind("cudaMemcpy") == "syncs"
    assert call_kind("cudaStreamSynchronize") == "syncs"
    assert call_kind("cudaGetDevice") is None and call_kind("cudaStreamWaitEvent") is None


def _x(cat, name, ts, dur, tid=10, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_table_of_a_written_trace():
    """Thread 10: quake.search [0, 100) > quake.dispatch [10, 60) >
    quake.scan [20, 40), a kernel launched in each of scan and dispatch, an
    async copy to pinned memory in dispatch, a stream synchronise and a
    copy from pageable memory (a sync) in search, and a launch outside
    every span. Thread 11, at the same time: quake.dispatch [30, 70)
    > quake.plan.merge [50, 60), a runtime and a driver launch in dispatch,
    a call that is neither in merge."""
    ua = "user_annotation"
    events = [
        _x(ua, "quake.search", 0, 100),
        _x(ua, "quake.dispatch", 10, 50),
        _x(ua, "quake.scan", 20, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 50, 1, corr=3),
        _x("cpu_op", "aten::copy_", 49, 3),
        _x("cuda_runtime", "cudaStreamSynchronize", 70, 20),
        _x("cuda_runtime", "cudaMemcpyAsync", 92, 3, corr=6),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=9),
        _x(ua, "quake.dispatch", 30, 40, tid=11),
        _x(ua, "quake.plan.merge", 50, 10, tid=11),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 2, tid=11, corr=4),
        _x("cuda_driver", "cuLaunchKernel", 40, 2, tid=11, corr=5),
        _x("cuda_runtime", "cudaGetDevice", 52, 1, tid=11),
        # The device's side: kernels and a copy by correlation id, and the
        # device's projection of a host span, which is no span.
        _x("kernel", "grouped_scan_mma_kernel", 30, 30, pid=0, tid=7, corr=1),
        _x("kernel", "merge_positions_kernel", 60, 5, pid=0, tid=7, corr=2),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 65, 4, pid=0, tid=7, corr=3),
        _x("kernel", "k4", 70, 6, pid=0, tid=7, corr=4),
        _x("kernel", "k5", 76, 8, pid=0, tid=7, corr=5),
        _x("kernel", "k9", 160, 7, pid=0, tid=7, corr=9),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 93, 2, pid=0, tid=7, corr=6),
        _x("gpu_user_annotation", "quake.scan", 30, 30, pid=0, tid=7),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 10, "ts": 25, "id": 1},
    ]
    table = span_table(events)
    assert table == {
        "quake.search": dict(calls=1, host_ms=0.1, self_ms=0.05, launches=0, syncs=2,
                             device_ms=0.041),
        "quake.dispatch": dict(calls=2, host_ms=0.09, self_ms=0.06, launches=4, syncs=0,
                               device_ms=0.053),
        "quake.scan": dict(calls=1, host_ms=0.02, self_ms=0.02, launches=1, syncs=0,
                           device_ms=0.03),
        "quake.plan.merge": dict(calls=1, host_ms=0.01, self_ms=0.01, launches=0, syncs=0,
                                 device_ms=0.0),
    }
