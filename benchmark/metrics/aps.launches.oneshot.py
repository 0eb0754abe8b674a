"""APS plan: device work a search call enqueues inside the spans
quake.aps.setup and quake.aps.plan (kernel launches, async copies, sets),
in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.aps.setup", "quake.aps.plan"], ["quake.search"], "launches")
