"""The harness's general part: BENCHMARK.json, the data files and readers it
names, the statistics, the import check and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name BENCHMARK.json gives:
- configs: `file` of the configuration's entry (benchmark/configs/<name>.json);
- traffic: benchmark/traffic/<traffic>.json, whose `kind` names the client
  loop benchmark/kinds/<kind>.py;
- limits of the comparison that decides `correct`: benchmark/limits/<cell>.json;
- per-layer metrics: benchmark/metrics/<metric name>.py, each with a
  `read(readings)` that returns a number, or None where it finds nothing;
  where that file is missing, the name without its last dotted part serves
  it (`device.idle_pct.py` serves `device.idle_pct.search` and
  `device.idle_pct.churn`, one quantity that moves two end-to-end metrics).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level module names no run may hold: the JAX stack and the JAX package
# (compared whole: quake_tpu_torch begins with quake_tpu).
FORBIDDEN = ("jax", "jaxlib", "flax", "quake_tpu")


@dataclass
class Readings:
    """What the per-layer metric readers read, filled by a traffic kind."""
    calls: list = field(default_factory=list)  # search calls of the measured window
    ops: list = field(default_factory=list)  # churn ops of the measured window
    trace: object = None  # tracing.TraceSummary of the traced window
    traced_calls: int = 0  # search calls in the traced window
    bound_s: float = 0.0  # roofline bound summed over the traced calls


def sync(device) -> None:
    """Wait for the device's work, where the device is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def end_phase(phases: dict, name: str, t0: float, device) -> float:
    """Record a set-up phase that began at t0, its device work done; returns
    the time it ended."""
    sync(device)
    t = time.perf_counter()
    phases[name] = t - t0
    return t


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in spec['workloads'])})")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell}.json")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    return load_module(BENCH / "kinds" / f"{name}.py", f"benchmark_kind_{name}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / (name.rsplit(".", 1)[0] + ".py")
    return load_module(path, "benchmark_metric_" + path.stem.replace(".", "_").replace("-", "_"))


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, or list no cells and move an end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all values (q in (0, 100])."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return float(v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)])


def mean(values) -> float:
    v = list(values)
    if not v:
        raise ValueError("mean of no values")
    return float(sum(v) / len(v))


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in `modules` (default sys.modules) that are FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def judge(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """(correct, checks): every number compared with its limit; a number
    that is missing, not a number, or over its limit is not correct."""
    checks, ok = {}, True
    for name, lim in lims.items():
        value = numbers.get(name)
        good = isinstance(value, (int, float)) and not math.isnan(value) and value <= lim
        ok = ok and good
        checks[name] = {"value": value, "limit": lim}
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None) -> str:
    """The run's last line of standard output; `checks` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
