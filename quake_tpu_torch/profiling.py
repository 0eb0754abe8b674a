"""Profiling helpers: spans, device traces and their span table, and timing
aggregation (the counterpart of quake_tpu/profiling.py).

``annotate(name)`` opens a span. While a profiler records on the calling
thread it is a ``torch.profiler.record_function``, so host spans share the
clock of the device events in the same trace; otherwise it is one check
and a shared no-op context. The port's spans are named
``quake.<layer>[.<stage>]`` and nest on one thread:

  quake.build                   QuakeIndex.build (the top level's), around its
                                stages:
    quake.build.kmeans          k-means training and the full assignment
    quake.build.balance         the split rounds of kmeans.balance_clusters
    quake.build.fill            the partition store filled (SOAR's second
                                assignment first, on a spilled build)
    quake.build.parent          the parent index over the centroids
    quake.build.calibrate       calibrate_aps, ending in a sync on a card
  quake.search                  QuakeIndex.search, around its four phases:
    quake.buffer_init, quake.dispatch, quake.device_wait, quake.aggregate
  quake.plan.parent             parent ranking (K3) and the self-heal (the
                                fused oneshot APS: K3 and the clip to mcap)
  quake.aps.setup               APS set-up: the candidates' centroids gathered,
                                the boundary distances, the beta table
  quake.aps.plan                APS plan: the radius (predicted for oneshot,
                                from the prologue for planned, each step of
                                the loop), the recall profile, the depths,
                                the margin and rounding, the width clip and
                                the pair budget
  quake.plan.grouping           the grouping prologue of a grouped scan
  quake.scan                    the grouped scan's kernel (K1, K4-K7, ...)
  quake.plan.placement          the placement epilogue (v10, v11)
  quake.plan.merge, .rescore    the pool merge or selection (K2), the rescore
  quake.plan.distances          scores to distances
  quake.plan.shard_merge        the sharded search's gather and merge
  quake.plan.hits               the maintenance hit window's record
  quake.add, .validate, .assign QuakeIndex.add, its id checks, its assignment
  quake.remove                  QuakeIndex.remove
  quake.store.append, .remove, .grow   PartitionStore's writes and growth
  quake.maintenance             QuakeIndex.maintenance
  quake.maint.window, .decide, .delete, .split, .refine, .invalidate
                                the policy's stages (maintenance/policy.py)
    quake.maint.reject          inside .decide, one delete-rejection
                                simulation (a parent search): its calls are
                                the round's rejection candidates

``device_trace(logdir)`` records a ``torch.profiler`` trace of a block (host
operations, and the device's kernels and copies where there is a card) and
writes it to logdir/trace.json as a Chrome trace. On exit it reduces the
trace to the span table (``span_table``), keeps it as ``last_spans()`` and
writes it to logdir/spans.json. ``device_summary`` reads a profile's device
time by operation; ``flatten_timing`` flattens a recursive SearchTimingInfo.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"  # device_trace's Chrome trace, in its logdir
SPANS_FILE = "spans.json"  # device_trace's span table, beside it

SPAN_CAT = "user_annotation"  # a record_function range on the host
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# CUDA runtime and driver calls that enqueue device work without waiting.
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemcpy3DAsync",
    "cudaMemcpyPeerAsync", "cudaMemcpyToSymbolAsync", "cudaMemcpyFromSymbolAsync",
    "cudaMemset", "cudaMemsetAsync", "cudaMemset2DAsync", "cudaMemset3DAsync",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel", "cuGraphLaunch",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync", "cuMemcpyDtoHAsync", "cuMemcpyDtoDAsync",
    "cuMemsetD8Async", "cuMemsetD16Async", "cuMemsetD32Async",
})
# CUDA runtime and driver calls that block the host until the device has
# done work: stream, device, context and event synchronises, and the
# synchronous copies. A copy launched by a call of LAUNCH_CALLS to or from
# pageable host memory (its device copy's name says "Pageable") blocks the
# host too, and counts as a sync.
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyPeer", "cudaMemcpyToSymbol",
    "cudaMemcpyFromSymbol",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyHtoD", "cuMemcpyDtoH", "cuMemcpyDtoD",
})

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
_last_spans: Optional[dict] = None


def annotate(name: str):
    """A span named `name`: a record_function while a profiler records on
    this thread, else a shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Trace a block with torch.profiler, write the trace to logdir/trace.json
    (default: quake_tpu_trace under the temporary directory) and the span
    table of its spans to logdir/spans.json (see span_table; last_spans()
    returns it). Records host operations, and CUDA kernels and copies where
    a card is present. Yields the profiler, whose key_averages() the caller
    may read after the block::

        with device_trace("traces/search") as prof:
            index.search(q, params)
        last_spans()["quake.dispatch"]["host_ms"]
    """
    from torch.profiler import ProfilerActivity, profile

    global _last_spans
    logdir = logdir or os.path.join(tempfile.gettempdir(), "quake_tpu_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    _last_spans = span_table(data["traceEvents"] if isinstance(data, dict) else data)
    with open(os.path.join(logdir, SPANS_FILE), "w") as f:
        json.dump(_last_spans, f, indent=1, sort_keys=True)


def last_spans() -> Optional[dict]:
    """The span table of the last device_trace to close (None before the
    first)."""
    return _last_spans


def call_kind(name: str) -> Optional[str]:
    """"launches" or "syncs" for a CUDA runtime or driver call's name, else
    None."""
    if name in LAUNCH_CALLS:
        return "launches"
    if name in SYNC_CALLS:
        return "syncs"
    return None


def span_table(events: list) -> dict:
    """One row per span name of a Chrome trace's events (dicts with ph, cat,
    name, pid, tid, ts and dur in microseconds, args), on the trace's own
    clock:

      calls      the spans of that name
      host_ms    the sum of their durations
      self_ms    host_ms less what child spans on the same thread cover
      launches   the calls of LAUNCH_CALLS made while the span was the
                 innermost one open on the calling thread
      syncs      the calls of SYNC_CALLS, and the launched copies to or from
                 pageable memory, counted the same way (a PyTorch copy of a
                 device tensor to the host reads as two: the copy, and the
                 stream synchronise after it)
      device_ms  the device time (kernels, copies, sets) of the operations
                 launched while the span was open on the thread, at any
                 depth below it, joined to their launch through the trace's
                 correlation ids

    Spans are the record_function ranges (category user_annotation); a
    call made where no span is open counts nowhere."""
    launched_us: dict = {}  # correlation id -> device microseconds
    pageable: set = set()  # correlation ids of copies to or from pageable memory
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched_us[corr] = launched_us.get(corr, 0.0) + float(e.get("dur", 0.0))
                if "Pageable" in str(e.get("name", "")):
                    pageable.add(corr)
    threads: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        if cat == SPAN_CAT:
            kind = None
        elif cat in RUNTIME_CATS:
            kind = call_kind(str(e.get("name", "")))
            if kind is None:
                continue
        else:
            continue
        # At one start, spans open before the calls they hold, outer first.
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(
            (float(e["ts"]), kind is not None, -float(e["dur"]), kind, e))

    table: dict = {}

    def row(name: str) -> dict:  # times in microseconds until the end
        return table.setdefault(name, dict(calls=0, host_ms=0.0, self_ms=0.0, launches=0,
                                           syncs=0, device_ms=0.0))

    for items in threads.values():
        items.sort(key=lambda t: t[:3])
        stack: list = []  # open spans, outermost first: [end, name, self us]
        for ts, _, neg_dur, kind, e in items:
            while stack and stack[-1][0] <= ts:
                _, name, self_us = stack.pop()
                row(name)["self_ms"] += self_us
            if kind is None:
                dur = -neg_dur
                name = str(e["name"])
                r = row(name)
                r["calls"] += 1
                r["host_ms"] += dur
                if stack:
                    stack[-1][2] -= min(ts + dur, stack[-1][0]) - ts
                stack.append([ts + dur, name, dur])
            elif stack:
                corr = (e.get("args") or {}).get("correlation")
                row(stack[-1][1])["syncs" if corr in pageable else kind] += 1
                dev = launched_us.get(corr)
                if dev:
                    for name in {s[1] for s in stack}:
                        row(name)["device_ms"] += dev
        for _, name, self_us in stack:
            row(name)["self_ms"] += self_us
    for r in table.values():
        for key in ("host_ms", "self_ms", "device_ms"):
            r[key] /= 1000.0
    return table


def device_us(evt) -> float:
    """Self device time of a profiler average of device events (kernels,
    copies, sets; the attribute's name moved across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def device_summary(prof, reps: int = 1) -> tuple[float, list[tuple[str, float]]]:
    """The device's busy ms per rep of a traced block (its device events'
    self time summed; one stream, so they do not overlap) and each device
    operation's ms per rep, longest first. Busy is 0 where the profiler
    recorded no device time."""
    ops = sorted(((e.key, device_us(e) / 1e3 / reps) for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and device_us(e) > 0),
                 key=lambda kv: -kv[1])
    return sum(ms for _, ms in ops), ops


def flatten_timing(info, prefix: str = "") -> dict:
    """Flatten a (recursive) SearchTimingInfo into a flat metric dict."""
    out = {}
    for field in (
        "n_queries",
        "n_clusters",
        "partitions_scanned",
        "buffer_init_time_ns",
        "job_enqueue_time_ns",
        "boundary_distance_time_ns",
        "job_wait_time_ns",
        "result_aggregate_time_ns",
        "total_time_ns",
    ):
        out[prefix + field] = getattr(info, field, 0)
    if getattr(info, "parent_info", None) is not None:
        out.update(flatten_timing(info.parent_info, prefix + "parent."))
    return out
