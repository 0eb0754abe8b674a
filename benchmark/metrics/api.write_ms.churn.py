"""Index API and storage: mean host ms of an insert or delete op of the
measured window (QuakeIndex.add or .remove, ending in a synchronisation)."""

from benchmark import core


def read(r):
    v = [o["ms"] for o in r.ops if o["type"] in ("insert", "delete")]
    return core.mean(v) if v else None
