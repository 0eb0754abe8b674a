"""Stage timing of the search path with CUDA events.

The search functions take an optional ``stages`` object and call
``stages.mark(name)`` as each stage ends; with ``stages=None`` (the default)
nothing is recorded and nothing is synchronised. ``StageTimer`` records one
CUDA event per mark on the current stream, so the stage times are device
times between consecutive marks, read once after the run.
"""

from __future__ import annotations

import torch


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
