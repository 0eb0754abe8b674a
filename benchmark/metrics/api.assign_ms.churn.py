"""Index API: host ms of the quake.add.assign span (the partition of
each new vector through the parent, and the splits that make room) an
insert, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.add.assign"], ["quake.add"])
