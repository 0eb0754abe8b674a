"""A whole run of a cell, cut to a CPU size: the result line's keys, the
import check, and the exits where no result may be printed."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import core
from benchmark.run import run_cell

ROOT = core.ROOT


def _run(cell, tiny, trace=False, seed=2**31 + 11):
    spec, cfg, tr, lims = tiny(cell)
    return run_cell(cell, seed, 0.5, trace, torch.device("cpu"), time.perf_counter(), spec=spec,
                    cfg=cfg, traffic=tr, lims=lims)


@pytest.mark.parametrize("cell", ["sift1m-f32.batch16k", "sift1m-bf16.batch16k", "sift1m-f32.churn"])
def test_last_line_has_the_keys(cell, tiny):
    res, checks, lines = _run(cell, tiny)
    line = core.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                            res["device"], checks, breakdown=res["breakdown"])
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    spec = core.load_spec()
    assert set(out["metrics"]) == {m["name"] for m in core.cell_metrics(spec, cell, "end_to_end")}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(checks) == set(core.limits(cell))
    assert lines[-len(checks):] == [f"check {n}: {c['value']} (limit {c['limit']})"
                                    for n, c in checks.items()]


def test_traced_line_carries_layer_metrics_and_breakdown(tiny):
    res, checks, _ = _run("sift1m-f32.batch16k", tiny, trace=True)
    line = json.loads(core.result_line(res["correct"], res["attempted"], res["failed"],
                                       res["metrics"], res["device"], checks,
                                       breakdown=res["breakdown"]))
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    # The CPU runs no device operation: the device's metrics stay silent.
    assert "api.copy_ms.search" in line["metrics"]
    assert "kernels.roofline_pct.search" not in line["metrics"]


def test_forbidden_modules_compare_whole_top_level_names():
    assert core.forbidden_modules(["quake_tpu_torch", "quake_tpu_torch.index", "jaxtyping",
                                   "numpy", "flaxen"]) == []
    assert core.forbidden_modules(["jax.numpy", "quake_tpu", "quake_tpu.index", "jaxlib",
                                   "flax.linen"]) == ["flax", "jax", "jaxlib", "quake_tpu"]


def test_a_run_imports_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            "from conftest import tiny_cell; from benchmark import core; from benchmark.run import run_cell;"
            "spec, cfg, tr, lims = tiny_cell('sift1m-f32.churn');"
            "run_cell('sift1m-f32.churn', 3, 0.3, False, torch.device('cpu'), time.perf_counter(),"
            " spec=spec, cfg=cfg, traffic=tr, lims=lims);"
            "print(core.forbidden_modules())") % (str(ROOT), str(ROOT / "benchmark" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sift1m-f32.batch16k",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, env={"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "")})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cut_down_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    spec, cfg, tr, lims = tiny("sift1m-f32.batch16k")
    res, checks, _ = run_cell("sift1m-f32.batch16k", 5, 0.5, True, torch.device("cuda:0"),
                              time.perf_counter(), spec=spec, cfg=cfg, traffic=tr, lims=lims)
    assert res["correct"], checks
    assert res["device"]["busy_s"] > 0
