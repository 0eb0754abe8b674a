"""The port's oneshot recall-target search held to the plain reference of
its plan (benchmark/aps.py), on the CPU: a seeded 20,000 x 32
corpus on a 12-dimensional manifold, nlist 64, APS calibrated at build,
four batches of 512 queries at recall_target 0.9 in aps_mode "oneshot".

- Depths: the partitions each query scanned (SearchTimingInfo.
  scanned_per_query) equal the reference's plan on at least 99% of queries
  and never differ by more than one rounding step; the pair budget is the
  reference's.
- Answers: the exact top-k over the partitions each query scanned (the
  port's own ranking to its own depth), up to one step of the scan's key.
- plan_gap: the benchmark's limit (benchmark/limits/) passes the program's
  depths and refuses a plan one rounding step shallower on 5% of rows and a
  reference whose recall profile runs in bfloat16.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import aps as ref
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, coordinator

N, D, NLIST, K, B, TARGET = 20000, 32, 64, 10, 512, 0.9
QUERY_SEEDS = (2, 3, 4, 5)
LIMITS = Path(__file__).resolve().parents[1] / "benchmark/limits/sift1m-f32-nl1024-aps.oneshot4k.json"


def manifold(n: int, seed: int, zdim: int = 12, centers: int = 1024) -> np.ndarray:
    """Points of 1,024 Gaussian clusters on a 12-dimensional manifold in D
    dimensions, plus noise; the manifold fixed, the points from `seed`."""
    g = np.random.default_rng(99)
    A = g.standard_normal((zdim, D)) / math.sqrt(zdim)
    C = g.standard_normal((centers, zdim)) * 1.5
    r = np.random.default_rng(seed)
    z = C[r.integers(0, centers, n)] + r.standard_normal((n, zdim))
    return (z @ A + 0.05 * r.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def searched():
    x = manifold(N, 1)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(nlist=NLIST, calibrate_aps=True))
    assert idx.aps_radius_ab is not None and idx.aps_budget_w > 0
    state = ref.ApsState.of(idx, K)
    s = idx.store.state
    live = torch.nonzero(s.active)[:, 0]
    pst = idx.parent.store.state
    out = []
    for seed in QUERY_SEEDS:
        q = manifold(B, seed)
        res = idx.search(q, SearchParams(k=K, recall_target=TARGET, aps_mode="oneshot"))
        qt = torch.from_numpy(q)
        pids, depth, budget = ref.plan(qt, s.centroids[live], state, TARGET)
        bf16 = ref.plan(qt, s.centroids[live], state, TARGET, precision="bf16")[1]
        ranked = coordinator.rank_parents(pst.codes, pst.ids, pst.norms, qt, state.width, "l2",
                                          idx._parent_kernel()).long()
        out.append(dict(q=qt, res=res, ref_depth=depth.numpy(), ref_budget=budget,
                        bf16_depth=bf16.numpy(), ranked=ranked, ref_pids=live[pids]))
    rows = [s.ids[p][:int(s.sizes[p])].long() for p in range(s.ids.shape[0])]
    return dict(x=torch.from_numpy(x), batches=out, rows=rows, C=int(s.codes.shape[1]))


def topk_over_plan(q: torch.Tensor, vectors: torch.Tensor, part_rows: list,
                   pids: torch.Tensor, depth: torch.Tensor, k: int):
    """The exact k nearest (l2) of each query's planned partitions: rows
    part_rows[p] (int64 indexes of `vectors`, also the ids returned) of the
    first depth[b] candidates pids[b]. Returns (ids [B, k] int64, -1 where
    fewer; l2 distances [B, k] float64, inf there), in float64."""
    B = q.shape[0]
    ids = torch.full((B, k), -1, dtype=torch.int64)
    dist = torch.full((B, k), float("inf"), dtype=torch.float64)
    for b in range(B):
        rows = torch.cat([part_rows[int(p)] for p in pids[b, :int(depth[b])].tolist()]
                         + [torch.zeros(0, dtype=torch.int64)])
        if rows.numel() == 0:
            continue
        d2 = ((vectors[rows].double() - q[b].double()[None, :]) ** 2).sum(dim=1)
        kk = min(k, rows.numel())
        dv, di = torch.topk(d2, kk, largest=False)
        ids[b, :kk] = rows[di]
        dist[b, :kk] = torch.sqrt(dv)
    return ids, dist


def _depths(searched, key):
    return np.concatenate([b[key] if key != "program" else
                           b["res"].timing_info.scanned_per_query for b in searched["batches"]])


def test_depths_match_the_plain_reference(searched):
    prog, want = _depths(searched, "program"), _depths(searched, "ref_depth")
    assert prog.dtype == np.int32 and prog.shape == (B * len(QUERY_SEEDS),)
    assert np.mean(prog == want) >= 0.99
    assert np.abs(prog.astype(np.int64) - want).max() <= 4
    for b in searched["batches"]:
        assert b["res"].timing_info.aps_pair_budget == b["ref_budget"] > 0
        assert torch.equal(b["ranked"], b["ref_pids"])  # the CPU's parent ranking is exact


def test_answers_are_the_exact_topk_of_the_scanned_partitions(searched):
    """The port's answers against the exact top-k over the partitions each
    query scanned: every id one of those rows, its distance exact, and the
    j-th nearest answer within one key step of the j-th exact distance (the
    scan selects by a key of (max |q| + max |x|)^2 / levels a step)."""
    x, rows = searched["x"], searched["rows"]
    slot_mult = max(1 << int(searched["C"] - 1).bit_length(), 2)
    levels = (1 << 24) // slot_mult - 2
    xmax = float(torch.sqrt((x.double() ** 2).sum(1).max()))
    hits = total = 0
    for b in searched["batches"]:
        q, res = b["q"], b["res"]
        depth = torch.from_numpy(res.timing_info.scanned_per_query.astype(np.int64))
        want_ids, want_d = topk_over_plan(q, x, rows, b["ranked"], depth, K)
        got = torch.from_numpy(res.ids)
        hits += int((got[:, :, None] == want_ids[:, None, :]).any(2).sum())
        total += got.numel()
        step = (float(torch.sqrt((q.double() ** 2).sum(1).max())) + xmax) ** 2 / levels
        for i in range(B):
            scanned = torch.cat([rows[p] for p in b["ranked"][i, :int(depth[i])].tolist()])
            assert bool(torch.isin(got[i], scanned).all())
        exact = torch.sqrt(((x[got].double() - q[:, None, :].double()) ** 2).sum(-1))
        np.testing.assert_allclose(res.distances, exact.numpy(), rtol=1e-5, atol=1e-5)
        gap = torch.sort(exact ** 2, dim=1).values - want_d ** 2
        assert float(gap.max()) <= step
    assert hits / total >= 0.99


@pytest.mark.parametrize("side, refused", [("program", False), ("shallower", True),
                                           ("bf16", True)])
def test_plan_gap_limit(searched, side, refused):
    """plan_gap, the share of rows whose depth differs from the reference's,
    against the benchmark's limit: the program passes; a plan one rounding
    step shallower on every 20th row, and the reference with its profile in
    bfloat16, do not."""
    limit = json.loads(LIMITS.read_text())["plan_gap"]
    want = _depths(searched, "ref_depth")
    if side == "program":
        got = _depths(searched, "program").astype(np.int64)
    elif side == "shallower":
        got = want.copy()
        got[::20] -= 4
    else:
        got = _depths(searched, "bf16_depth")
    gap = float(np.mean(got != want))
    assert (gap > limit) == refused, (gap, limit)
