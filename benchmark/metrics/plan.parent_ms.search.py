"""Parent ranking: host ms of the quake.plan.parent span (kernel K3 and
the self-heal of the probe lists) a search call, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.plan.parent"], ["quake.search"])
