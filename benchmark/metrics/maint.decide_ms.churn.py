"""Maintenance: host ms of the quake.maint.decide span (the cost model
over every partition, and the delete rejection) a maintenance() call, in
the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.maint.decide"], ["quake.maintenance"])
