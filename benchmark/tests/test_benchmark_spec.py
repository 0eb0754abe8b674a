"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file that serves it (the harness finds them by name)."""

import json
import re

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    spec = core.load_spec()
    assert set(spec) == KEYS
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024
    # A full check of 24 cells fits its 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    spec = core.load_spec()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def test_every_name_has_its_file():
    spec = core.load_spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        cfg = core.config(spec, w["config"])
        tr = core.traffic(w["traffic"])
        assert hasattr(core.kind(tr["kind"]), "Run")
        assert core.limits(w["name"])
        assert cfg["name"] == w["config"]
        got = {m["name"] for m in core.cell_metrics(spec, w["name"], "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert core.cell_metrics(spec, w["name"], "per_layer")
    for m in spec["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells


def test_configuration_files_state_their_cut():
    spec = core.load_spec()
    for c in spec["configs"]:
        cfg = core.load_json(core.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
