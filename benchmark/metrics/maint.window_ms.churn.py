"""Maintenance: host ms of the hit window (the quake.maint.window and
quake.maint.invalidate spans: the window read back and aggregated, then
its rows invalidated) a maintenance() call, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.maint.window", "quake.maint.invalidate"],
                          ["quake.maintenance"])
