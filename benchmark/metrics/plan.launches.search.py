"""Search plan: device work a search call enqueues (kernel launches,
async copies, sets: the span table's launches over quake.search and every
span inside it), in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(spans.search_spans(), ["quake.search"], "launches")
