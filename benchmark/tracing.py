"""Reading a traced window: device busy time, device time by operation, and
the device's idle gaps by the host phase they fall in.

The traced window is recorded by the program's own `device_trace`
(quake_tpu_torch.profiling, torch.profiler), which writes a Chrome trace.
Device operations are its events of the categories in `DEVICE_CATS`; host
phases are its `user_annotation` events: the program's `quake.*` phases
inside `QuakeIndex.search`, and the benchmark's own `bench.*` spans around
each call it makes. The window is the benchmark's `bench.window` span.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces of no
    name, template arguments and parameters ("Memcpy HtoD", "at::native::
    vectorized_gather_kernel", "grouped_scan_mma_kernel")."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (", 1)[0]
    name = name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    m = re.match(r"\s*([A-Za-z_][A-Za-z0-9_:]*)", name)
    return m.group(1) if m else (name.strip() or "?")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)  # short name -> seconds
    idle_gaps: dict = field(default_factory=dict)  # host phase -> seconds
    n_device_events: int = 0

    def op_seconds(self, needle: str) -> float:
        return sum(s for n, s in self.device_ops.items() if needle in n)

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> TraceSummary:
    """Reduce a Chrome trace's events (dicts with ph, cat, name, ts, dur in
    microseconds) to the window's summary."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    w0 = min(float(e["ts"]) for e in windows)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in windows)
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    ops: dict = {}
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        key = short_name(str(e.get("name", "?")))
        ops[key] = ops.get(key, 0.0) + (t - s) * 1e-6
    busy = _union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, device_ops=ops,
                        idle_gaps=_idle_by_phase(spans, busy, w0, w1),
                        n_device_events=len(dev))


def _idle_by_phase(spans, busy, w0: float, w1: float) -> dict:
    """Seconds of each idle gap of the device inside the window, summed by
    the innermost host span (quake.* or bench.*, not the window itself) that
    covers the gap's middle."""
    notes = sorted(((float(e["ts"]), -float(e["dur"]), str(e["name"]))
                    for e in spans if e.get("cat") == "user_annotation"
                    and e.get("name") != WINDOW_SPAN))
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    out: dict = {}
    stack: list = []  # open spans, outermost first (the host's spans nest)
    i = 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while i < len(notes) and notes[i][0] <= mid:
            start, neg_dur, name = notes[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((start - neg_dur, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        phase = stack[-1][1] if stack else "[no host span]"
        out[phase] = out.get(phase, 0.0) + (e - s) * 1e-6
    return out


def read(path) -> TraceSummary:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)
