"""Storage: host ms of the store's writes (the quake.store.append and
quake.store.remove spans) an insert or delete, in the traced window."""

from benchmark import spans


def read(r):
    return spans.per_call(["quake.store.append", "quake.store.remove"],
                          ["quake.add", "quake.remove"])
