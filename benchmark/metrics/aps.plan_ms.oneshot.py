"""APS plan: host ms of the quake.aps.plan span (the predicted radius, the
recall profile, the depths, the margin and rounding, the width clip and the
pair budget) a search call, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.aps.plan"], ["quake.search"])
