"""The reference's account of the scan's keys against the program: the key
scale it assumes is the one the program's search uses, and a selection that
breaks the key's bound comes out not correct."""

import time

import pytest
import torch

import quake_tpu_torch.ops.grouped_scan as grouped_scan
from benchmark import core
from benchmark.run import run_cell

SEARCH_CELLS = ["sift1m-f32.batch16k", "sift1m-bf16.batch16k"]


@pytest.mark.parametrize("cell", SEARCH_CELLS)
def test_program_key_scale_is_the_references(cell, tiny, monkeypatch):
    """Every search of the window quantizes on the scale reference.key_scale
    works out from the inputs: the same floor and step, to float32."""
    spec, cfg, tr, _ = tiny(cell)
    run = core.kind(tr["kind"]).Run(cfg, tr, 31, torch.device("cpu"))
    run.setup()
    seen = []
    real = grouped_scan.global_scale

    def recording(q, norms, metric, levels, *a, **kw):
        out = real(q, norms, metric, levels, *a, **kw)
        seen.append((float(out[2]), 1.0 / float(out[3])))
        return out

    monkeypatch.setattr(grouped_scan, "global_scale", recording)
    run.window(0.3)
    monkeypatch.undo()
    run.collect()
    assert len(seen) == run.attempted > 0
    floor = [float(f) for f in run.floor[::int(tr["sample_rows_per_call"])]]
    step = [float(s) for s in run.step[::int(tr["sample_rows_per_call"])]]
    assert len(floor) == len(seen)
    for (g, st), f, s in zip(seen, floor, step):
        assert g == pytest.approx(f, rel=1e-5)
        assert st == pytest.approx(s, rel=1e-5)


def _other_rows(top_refs, ids):
    """Each winner (pid << 16 | slot) swapped for the filled slot half a
    partition away: other rows the query probes, not the ones selected."""
    C = ids.shape[1]
    pid = torch.clamp(top_refs >> 16, min=0)
    slot = top_refs & 0xFFFF
    other = (slot + C // 2) % C
    filled = ids[pid.long(), other.long()] >= 0
    swapped = (pid << 16) | torch.where(filled, other, slot)
    return torch.where(top_refs >= 0, swapped, top_refs)


@pytest.mark.parametrize("cell", SEARCH_CELLS)
def test_wrong_winners_scored_exactly_are_not_correct(cell, tiny, monkeypatch):
    """The scan selects other probed rows than its keys rank best, and the
    tail scores them: exactly (float32) or from the keys (bf16). The
    distances of the returned ids are right on the float32 cell; the
    selection is not."""
    exact, tail = grouped_scan.exact_rescore, grouped_scan.dequantized_tail
    monkeypatch.setattr(grouped_scan, "exact_rescore",
                        lambda top_refs, codes, ids, *a, **kw:
                        exact(_other_rows(top_refs, ids), codes, ids, *a, **kw))
    monkeypatch.setattr(grouped_scan, "dequantized_tail",
                        lambda keys, top_refs, ids, *a, **kw:
                        tail(keys, _other_rows(top_refs, ids), ids, *a, **kw))
    spec, cfg, tr, lims = tiny(cell)
    res, checks, _ = run_cell(cell, 33, 0.3, False, torch.device("cpu"), time.perf_counter(),
                              spec=spec, cfg=cfg, traffic=tr, lims=lims)
    assert not res["correct"]
    assert checks["sel_budget"]["value"] > checks["sel_budget"]["limit"], checks
    if "dist_err" in checks:
        assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"], checks
