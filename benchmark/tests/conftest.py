"""Shared set-up of the benchmark's tests: the repository root on the path,
and cells cut down to a size the CPU runs in seconds (the program's plain
PyTorch versions of its kernels)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import core  # noqa: E402

TINY_N = 40000


def tiny_cell(cell: str):
    """(spec, cfg, traffic, limits) of `cell` at a CPU size: the widths,
    the mix and the limits as the cell states them; fewer vectors,
    partitions and rows a batch."""
    spec = core.load_spec()
    w = core.workload(spec, cell)
    cfg = core.config(spec, w["config"])
    tr = core.traffic(w["traffic"])
    cfg["n"] = TINY_N
    cfg["build"]["nlist"] = 8
    cfg["build"]["niter"] = 4
    cfg["search"]["nprobe"] = 3
    if tr["kind"] == "search_batches":
        tr.update(batch=64, pool_batches=2, warmup_rounds=1)
    else:
        tr.update(update_batch=100, query_batch=16, warmup_rounds=1)
    tr["trace_seconds"] = 0.3
    return spec, cfg, tr, core.limits(cell)


@pytest.fixture
def tiny():
    return tiny_cell
