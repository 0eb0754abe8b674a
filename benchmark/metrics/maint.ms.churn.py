"""Maintenance: mean host ms of a QuakeIndex.maintenance() call of the
measured window (one after every op, ending in a synchronisation)."""

from benchmark import core


def read(r):
    v = [o["maint_ms"] for o in r.ops]
    return core.mean(v) if v else None
