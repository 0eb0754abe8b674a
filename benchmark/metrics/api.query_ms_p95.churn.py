"""Index API: the 95th percentile of the host ms of every query op of the
measured window (QuakeIndex.search of a small batch, numpy in and out)."""

from benchmark import core


def read(r):
    v = [o["ms"] for o in r.ops if o["type"] == "query"]
    return core.percentile(v, 95) if v else None
