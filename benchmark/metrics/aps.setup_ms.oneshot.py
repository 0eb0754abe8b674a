"""APS plan: host ms of the quake.aps.setup span (the candidates' centroids
gathered, the boundary distances, the beta table) a search call, in the
traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.aps.setup"], ["quake.search"])
