"""Search plan: host ms of the spans after the grouped scan
(quake.plan.placement, .merge, .rescore and .distances) a search call, in
the traced window."""

from benchmark import spans

TAIL = ["quake.plan.placement", "quake.plan.merge", "quake.plan.rescore", "quake.plan.distances"]


def read(r):
    return spans.per_call(TAIL, ["quake.search"])
