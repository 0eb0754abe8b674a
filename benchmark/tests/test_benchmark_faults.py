"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (one chip: no exchange between chips)."""

import time

import pytest
import torch

import quake_tpu_torch.coordinator as coordinator
from quake_tpu_torch.storage.store import PartitionStore
from benchmark.run import run_cell

FUSED = coordinator.fused_ivf_search


def _half_left_out(*args, **kw):
    """Half of the batch left out: the second half gets no answer."""
    scores, ids32, dists, scanned, pids = FUSED(*args, **kw)
    h = ids32.shape[0] // 2
    ids32, dists, scores = ids32.clone(), dists.clone(), scores.clone()
    ids32[h:] = -1
    dists[h:] = float("inf")
    scores[h:] = float("-inf")
    return scores, ids32, dists, scanned, pids


def _half_repeated(*args, **kw):
    """Half of the batch left out: the second half answered with the first's."""
    scores, ids32, dists, scanned, pids = FUSED(*args, **kw)
    h = ids32.shape[0] // 2
    ids32, dists = ids32.clone(), dists.clone()
    ids32[h:2 * h] = ids32[:h]
    dists[h:2 * h] = dists[:h]
    return scores, ids32, dists, scanned, pids


def _answer_altered(*args, **kw):
    """An answer altered where it is produced: each query's best id is
    another query's."""
    scores, ids32, dists, scanned, pids = FUSED(*args, **kw)
    ids32 = ids32.clone()
    ids32[:, 0] = torch.roll(ids32[:, 0], 1)
    return scores, ids32, dists, scanned, pids


def _judge(cell, tiny):
    spec, cfg, tr, lims = tiny(cell)
    res, checks, _ = run_cell(cell, 17, 0.3, False, torch.device("cpu"), time.perf_counter(),
                              spec=spec, cfg=cfg, traffic=tr, lims=lims)
    return res["correct"], checks


@pytest.mark.parametrize("cell", ["sift1m-f32.batch16k", "sift1m-bf16.batch16k", "sift1m-f32.churn"])
def test_sound_run_is_correct(cell, tiny):
    ok, checks = _judge(cell, tiny)
    assert ok, checks


@pytest.mark.parametrize("cell", ["sift1m-f32.batch16k", "sift1m-bf16.batch16k", "sift1m-f32.churn"])
@pytest.mark.parametrize("fault", [_half_left_out, _half_repeated, _answer_altered])
def test_search_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    monkeypatch.setattr(coordinator, "fused_ivf_search", fault)
    ok, checks = _judge(cell, tiny)
    assert not ok, checks


@pytest.mark.parametrize("method", ["append", "remove"])
def test_write_that_leaves_the_state_unchanged_is_not_correct(method, tiny, monkeypatch):
    """A step that returns its state unchanged: an acknowledged insert or
    delete that the store never applies."""
    monkeypatch.setattr(PartitionStore, method, lambda self, *a, **k: 0)
    ok, checks = _judge("sift1m-f32.churn", tiny)
    assert not ok, checks
    assert checks["store_err"]["value"] > 0
