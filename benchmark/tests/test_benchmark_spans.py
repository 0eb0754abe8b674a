"""The per-layer metrics that read the program's span table
(benchmark/spans.py): each gives None without a table or without its span,
and its number on a table written by hand."""

import pytest

from benchmark import core

NAMES = ("plan.parent_ms.search", "plan.grouping_ms.search", "plan.tail_ms.search",
         "plan.launches.search", "api.syncs.search", "api.assign_ms.churn",
         "storage.write_ms.churn", "maint.window_ms.churn", "maint.decide_ms.churn")


def _row(calls=1, host_ms=0.0, launches=0, syncs=0):
    return dict(calls=calls, host_ms=host_ms, self_ms=host_ms, launches=launches, syncs=syncs,
                device_ms=0.0)


# Four searches, ten adds, six removes and five maintenance() calls.
TABLE = {
    "bench.search": _row(4, 100.0, launches=3),
    "quake.search": _row(4, 80.0, syncs=1),
    "quake.dispatch": _row(4, 40.0, launches=8),
    "quake.device_wait": _row(4, 20.0, launches=4, syncs=4),
    "quake.aggregate": _row(4, 2.0, launches=4, syncs=4),
    "quake.plan.parent": _row(4, 6.0, launches=12),
    "quake.plan.grouping": _row(4, 14.0, launches=40),
    "quake.scan": _row(4, 1.0, launches=4),
    "quake.plan.placement": _row(4, 3.0, launches=20),
    "quake.plan.merge": _row(4, 2.0, launches=8),
    "quake.plan.rescore": _row(4, 4.0, launches=16),
    "quake.plan.distances": _row(4, 1.0, launches=4),
    "quake.add": _row(10, 50.0),
    "quake.add.validate": _row(10, 5.0),
    "quake.add.assign": _row(10, 30.0, launches=20, syncs=10),
    "quake.remove": _row(6, 12.0),
    "quake.store.append": _row(10, 9.0, launches=50),
    "quake.store.remove": _row(6, 7.0, launches=30),
    "quake.maintenance": _row(5, 80.0),
    "quake.maint.window": _row(5, 60.0, syncs=5),
    "quake.maint.invalidate": _row(5, 5.0),
    "quake.maint.decide": _row(5, 10.0),
}
EXPECTED = {
    "plan.parent_ms.search": 6.0 / 4,
    "plan.grouping_ms.search": 14.0 / 4,
    "plan.tail_ms.search": (3.0 + 2.0 + 4.0 + 1.0) / 4,
    "plan.launches.search": (8 + 4 + 4 + 12 + 40 + 4 + 20 + 8 + 16 + 4) / 4,
    "api.syncs.search": (1 + 4 + 4) / 4,
    "api.assign_ms.churn": 30.0 / 10,
    "storage.write_ms.churn": (9.0 + 7.0) / (10 + 6),
    "maint.window_ms.churn": (60.0 + 5.0) / 5,
    "maint.decide_ms.churn": 10.0 / 5,
}


def _with_table(monkeypatch, table):
    from quake_tpu_torch import profiling
    monkeypatch.setattr(profiling, "last_spans", lambda: table)


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_a_table(name, monkeypatch):
    reader = core.metric_reader(name)
    _with_table(monkeypatch, None)
    assert reader.read(core.Readings()) is None
    from quake_tpu_torch import profiling
    monkeypatch.delattr(profiling, "last_spans")  # a program with no span table
    assert reader.read(core.Readings()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_table(name, monkeypatch):
    reader = core.metric_reader(name)
    _with_table(monkeypatch, TABLE)
    assert reader.read(core.Readings()) == pytest.approx(EXPECTED[name], rel=1e-12)
    # Without the spans it reads, or without the calls it divides by: None.
    _with_table(monkeypatch, {"bench.search": _row(4, 100.0)})
    assert reader.read(core.Readings()) is None


def test_every_new_metric_is_in_the_spec():
    spec = core.load_spec()
    got = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        assert got[name]["source"] == "program_span"
        assert got[name]["workloads"]
