"""The program's span table of the traced window, for the per-layer metrics
that read it: `quake_tpu_torch.profiling.last_spans()`, one row per span
name (calls, host_ms, self_ms, launches, syncs, device_ms), computed by the
program's `device_trace` when the traced window closes, on the trace's own
clock. A version of the program that keeps no table gives every reader
None."""

from __future__ import annotations

# Spans of the writes and of maintenance; every other quake.* span opens
# inside quake.search (the search's phases and its plan's stages).
NOT_SEARCH = ("quake.add", "quake.remove", "quake.store.", "quake.maint")


def table():
    """The table of the last traced window, or None."""
    try:
        from quake_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "last_spans", None)
    return read() if callable(read) else None


def per_call(names, per, field: str = "host_ms"):
    """`field` summed over the spans `names`, over the calls of the spans
    `per`; None where there is no table, none of `names` ran, or no span of
    `per` did."""
    t = table()
    if not t or not any(n in t for n in names):
        return None
    calls = sum(t[n]["calls"] for n in per if n in t)
    if calls == 0:
        return None
    return sum(t[n][field] for n in names if n in t) / calls


def search_spans() -> list:
    """The names of quake.search and every span that opens inside it."""
    t = table() or {}
    return [n for n in t if n.startswith("quake.") and not n.startswith(NOT_SEARCH)]
