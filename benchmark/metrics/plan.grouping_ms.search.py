"""Search plan: host ms of the quake.plan.grouping span (the grouping
prologue ahead of the grouped scan) a search call, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.plan.grouping"], ["quake.search"])
