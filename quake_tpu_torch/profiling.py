"""Profiling helpers: device traces, host-phase annotations, timing
aggregation, and stage timing of the search path with CUDA events (the
counterpart of quake_tpu/profiling.py).

``device_trace`` records a ``torch.profiler`` trace of a block (host
operations, and the device's kernels and copies where there is a card) and
writes it to a directory as a Chrome trace; ``annotate`` labels a host phase
inside it (QuakeIndex.search labels its four: quake.buffer_init,
quake.dispatch, quake.device_wait, quake.aggregate); ``device_summary``
reads a trace's device time; ``flatten_timing`` flattens a recursive
SearchTimingInfo.

The search functions take an optional ``stages`` object and call
``stages.mark(name)`` as each stage ends; with ``stages=None`` (the default)
nothing is recorded and nothing is synchronised. ``StageTimer`` records one
CUDA event per mark on the current stream, so the stage times are device
times between consecutive marks, read once after the run.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"  # device_trace's Chrome trace, in its logdir


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Trace a block with torch.profiler and write the trace to
    logdir/trace.json (default: quake_tpu_trace under the temporary
    directory). Records host operations, and CUDA kernels and copies where a
    card is present. Yields the profiler, whose key_averages() the caller may
    read after the block::

        with device_trace("traces/search") as prof:
            index.search(q, params)
    """
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "quake_tpu_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A record_function context labelling a host phase inside a trace."""
    return torch.profiler.record_function(name)


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


def mark_stage(stages, name: str) -> None:
    """stages.mark(name) when a stages object was given."""
    if stages is not None:
        stages.mark(name)


class StageTimer:
    """Collects device time per named stage over one or more runs.

    Usage::

        st = StageTimer(device)
        st.start()
        fused_ivf_search(..., stages=st)
        st.stop()            # synchronises and accumulates
        st.ms                # {"parent": ..., "grouping": ..., ...}
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: dict[str, float] = {}
        self.runs = 0
        self._events: list[tuple[str, torch.cuda.Event]] = []

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> None:
        self._events = [("", self._event())]

    def mark(self, name: str) -> None:
        self._events.append((name, self._event()))

    def stop(self) -> None:
        self._events[-1][1].synchronize()
        for (_, a), (name, b) in zip(self._events, self._events[1:]):
            self.ms[name] = self.ms.get(name, 0.0) + a.elapsed_time(b)
        self.runs += 1
        self._events = []

    def mean_ms(self) -> dict[str, float]:
        return {k: v / max(self.runs, 1) for k, v in self.ms.items()}
