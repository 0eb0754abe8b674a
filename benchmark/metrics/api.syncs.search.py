"""Index API: the calls a search call makes that block the host on the
device (stream, device and event synchronises, synchronous copies: the
span table's syncs over quake.search and every span inside it), in the
traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(spans.search_spans(), ["quake.search"], "syncs")
