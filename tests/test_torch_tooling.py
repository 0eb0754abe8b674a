"""The port's tooling on the CPU: profiling.py (flatten_timing, device_trace,
annotate and the search's annotated host phases), datasets.py (the
synthetic sets equal to the JAX package's, array for array; the SIFT1M
loader's two offline layouts) and debug.py (the NaN trap: the search runs
clean under it, a NaN producer raises, the kernel wrappers' check, infs,
threads, QUAKE_TPU_DEBUG=1 at import)."""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from quake_tpu import datasets as jax_datasets
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
from quake_tpu_torch import datasets
from quake_tpu_torch.debug import check_kernel_outputs, disable_debug_mode, enable_debug_mode
from quake_tpu_torch.profiling import (TRACE_FILE, annotate, device_summary, device_trace,
                                       flatten_timing)
from quake_tpu_torch.timing import SearchTimingInfo
from quake_tpu_torch.utils import fvecs_write, ivecs_write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def index():
    x = np.random.default_rng(0).standard_normal((2000, 16)).astype(np.float32)
    idx = QuakeIndex(device="cpu")
    idx.build(x, np.arange(2000, dtype=np.int64), IndexBuildParams(nlist=8))
    return idx, x


def test_flatten_timing():
    """tests/test_misc.py:125, and a search's own timing flattened."""
    ti = SearchTimingInfo(n_queries=4, total_time_ns=100)
    ti.parent_info = SearchTimingInfo(n_queries=4, total_time_ns=10)
    flat = flatten_timing(ti)
    assert flat["total_time_ns"] == 100
    assert flat["parent.total_time_ns"] == 10
    assert "parent.parent.total_time_ns" not in flat


def test_flatten_search_timing(index):
    idx, x = index
    flat = flatten_timing(idx.search(x[:32], SearchParams(k=5, nprobe=4)).timing_info)
    assert flat["n_queries"] == 32 and flat["partitions_scanned"] == 4
    assert flat["parent.n_clusters"] == idx.parent.nlist() == 1  # a flat parent
    assert flat["total_time_ns"] >= flat["job_wait_time_ns"] > 0


def test_device_trace_and_annotate(index, tmp_path):
    """device_trace writes a Chrome trace holding the search's four host
    phases and a phase of the caller's own."""
    idx, x = index
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("caller.phase"):
            idx.search(x[:32], SearchParams(k=5, nprobe=4))
    path = tmp_path / "trace" / TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for phase in ("quake.buffer_init", "quake.dispatch", "quake.device_wait",
                  "quake.aggregate", "caller.phase"):
        assert phase in names, phase
    busy, ops = device_summary(prof)
    assert busy == 0.0 and ops == []  # the CPU records no device time


def test_device_trace_default_dir(monkeypatch, tmp_path):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with device_trace():
        torch.ones(4).sum()
    assert (tmp_path / "quake_tpu_trace" / TRACE_FILE).is_file()


@pytest.mark.parametrize("name,kw", [("random", dict(n=500, d=8, nq=10, seed=3)),
                                     ("clustered", dict(n=800, d=8, nq=12, n_centers=16,
                                                        seed=4))])
def test_synthetic_datasets_equal_jax(name, kw):
    """tests/test_misc.py:57 on the port: the registry, and each synthetic
    set equal to the JAX package's, array for array."""
    got = datasets.load_dataset(name, **kw)
    want = jax_datasets.load_dataset(name, **kw)
    assert got[0].shape == (kw["n"], 8) and got[2].shape == (kw["nq"], 100)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        datasets.load_dataset("nonexistent")


@pytest.mark.parametrize("layout", ["flat", "tarball"])
def test_dataset_component_loaders(tmp_path, monkeypatch, layout):
    """tests/test_misc.py:67 on the port: the per-component loaders agree
    with load(), and Sift1m reads both offline layouts, from a directory
    given or from QUAKE_TPU_DATA_DIR, without reaching download()."""
    ds = datasets.RandomDataset(n=200, d=8, nq=5)
    base, queries, gt = ds.load()
    np.testing.assert_array_equal(ds.load_vectors(), base)
    np.testing.assert_array_equal(ds.load_queries(), queries)
    np.testing.assert_array_equal(ds.load_ground_truth(), gt)

    root = tmp_path / "sift" if layout == "tarball" else tmp_path
    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    fvecs_write(str(root / "sift_base.fvecs"), rng.standard_normal((20, 4), dtype=np.float32))
    fvecs_write(str(root / "sift_query.fvecs"), rng.standard_normal((3, 4), dtype=np.float32))
    ivecs_write(str(root / "sift_groundtruth.ivecs"),
                rng.integers(0, 20, (3, 2)).astype(np.int32))

    def no_download(*a, **k):
        raise AssertionError("download() reached")

    monkeypatch.setattr(datasets.Dataset, "download", no_download)
    monkeypatch.setenv("QUAKE_TPU_DATA_DIR", str(tmp_path))
    for s in (datasets.Sift1m(str(tmp_path)), datasets.Sift1m()):
        assert s.download_dir == tmp_path and s.is_downloaded()
        v, q, g = s.load()
        assert v.shape == (20, 4) and q.shape == (3, 4)
        assert g.dtype == np.int64 and g.shape == (3, 2)
        want = jax_datasets.Sift1m(str(tmp_path)).load()
        for a, b in zip((v, q, g), want):
            np.testing.assert_array_equal(a, b)
    assert datasets.Sift1m("elsewhere").download_dir.name == "elsewhere"


def _stack_len() -> int:
    return torch._C._len_torch_dispatch_stack()


def test_debug_mode_traps_nans(index):
    """tests/test_misc.py:171 on the port: the search runs clean under
    debug mode (the plain versions' -inf sentinels allowed), a NaN
    producer raises, and disable_debug_mode() leaves nothing pushed."""
    idx, x = index
    n0 = _stack_len()
    enable_debug_mode()
    try:
        assert _stack_len() == n0 + 1
        for sp in (SearchParams(k=5, nprobe=8), SearchParams(k=5, nprobe=3, batched_scan=False)):
            res = idx.search(x[:32], sp)
            assert (res.ids[:, 0] == np.arange(32)).all()
        res = idx.search(x[:16], SearchParams(k=5, recall_target=0.9))
        assert (res.ids[:, 0] == np.arange(16)).all()
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.zeros(4) / torch.zeros(4)
        torch.full((3,), float("-inf")) * 2.0  # infs stay allowed
        with pytest.raises(FloatingPointError, match="kernel grouped_scan"):
            check_kernel_outputs("grouped_scan", torch.tensor([1.0, float("nan")]))
    finally:
        disable_debug_mode()
    assert _stack_len() == n0
    assert torch.isnan(torch.zeros(4) / torch.zeros(4)).all()  # off: no trap
    check_kernel_outputs("grouped_scan", torch.tensor([float("nan")]))


def test_debug_mode_infs_and_views():
    """trap_infs traps infs; views, in-place writes and uninitialised
    allocations are not checked."""
    enable_debug_mode(trap_infs=True)
    try:
        with pytest.raises(FloatingPointError, match="inf"):
            torch.ones(2) / torch.zeros(2)
        t = torch.empty(1000)  # whatever bits it holds
        t.fill_(float("nan"))  # in place: not checked
        t[:10]  # a view: not checked
    finally:
        disable_debug_mode()
    enable_debug_mode()  # trap_infs back to its default (QUAKE_TPU_DEBUG_INFS unset)
    try:
        torch.ones(2) / torch.zeros(2)
    finally:
        disable_debug_mode()


def test_debug_mode_threads():
    """A thread's trap is its own: a thread that enables and disables
    leaves its stack empty; the kernel checks follow the process-wide
    switch in every thread; after the switch is off a trap another thread
    still holds passes everything through."""
    out, ready, go = {}, threading.Event(), threading.Event()

    def worker():
        enable_debug_mode()
        out["pushed"] = _stack_len()
        try:
            torch.zeros(2) / torch.zeros(2)
        except FloatingPointError:
            out["trapped"] = True
        ready.set()
        go.wait(30)
        out["after_off"] = bool(torch.isnan(torch.zeros(2) / torch.zeros(2)).all())
        disable_debug_mode()
        out["left"] = _stack_len()

    t = threading.Thread(target=worker)
    t.start()
    assert ready.wait(30)
    with pytest.raises(FloatingPointError, match="kernel k"):
        check_kernel_outputs("k", torch.tensor([float("nan")]))  # on in this thread too
    assert _stack_len() == 0  # the worker's trap is not on this thread
    disable_debug_mode()
    go.set()
    t.join(30)
    assert not t.is_alive()
    assert out == {"pushed": 1, "trapped": True, "after_off": True, "left": 0}


def test_debug_mode_from_the_environment():
    """QUAKE_TPU_DEBUG=1 turns debug mode on when the package is imported."""
    code = textwrap.dedent("""
        import torch
        import quake_tpu_torch
        from quake_tpu_torch import debug
        assert debug.enabled()
        try:
            torch.zeros(2) / torch.zeros(2)
        except FloatingPointError:
            print("trapped")
    """)
    env = dict(os.environ, QUAKE_TPU_DEBUG="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "trapped", out.stderr
