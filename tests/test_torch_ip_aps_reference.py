"""The port's oneshot recall-target search on an inner-product index held to
the plain reference of its plan (benchmark/aps_ip.py), on the CPU: a seeded
20,000 x 32 corpus of unit vectors on a 12-dimensional manifold, bf16
codes, nlist 64 with a balance factor that splits clusters, APS calibrated
at build, two batches of 512 unit queries at recall_target 0.9 in aps_mode
"oneshot".

- Centroids: every centroid, the split ones among them, is unit-norm to
  1e-5 (kmeans.balance_clusters splits at the build's metric).
- Depths: the partitions each query scanned (SearchTimingInfo.
  scanned_per_query) equal the reference's plan on at least 99% of queries
  and never differ by more than one rounding step; the pair budget is the
  reference's; the CPU's parent ranking is the reference's, by q.c.
- Answers: the exact top-k by q.x over the partitions each query scanned,
  up to one step of K1's ip key plus the bf16 rounding of the query in the
  products, with every returned score the exact product with the stored row.
- plan_gap: the ip cell's limit (benchmark/limits/) passes the program's
  depths and refuses a plan one rounding step shallower on 5% of rows and a
  reference whose recall profile runs in bfloat16.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import aps, reference_ip
from benchmark import aps_ip as ref
from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, coordinator

N, D, NLIST, K, B, TARGET = 20000, 32, 64, 10, 512, 0.9
QUERY_SEEDS = (2, 3)
U_BF16 = 2.0 ** -8  # twice the rounding of the query to bf16 in K1's bf16 body
LIMITS = (Path(__file__).resolve().parents[1]
          / "benchmark/limits/deep10m-ip-bf16.oneshot16k-ip.json")


def unit_manifold(n: int, seed: int, zdim: int = 12, centers: int = 1024) -> np.ndarray:
    """Points of 1,024 Gaussian clusters on a 12-dimensional manifold in D
    dimensions, plus noise, each row divided by its norm; the manifold
    fixed, the points from `seed`."""
    g = np.random.default_rng(99)
    A = g.standard_normal((zdim, D)) / math.sqrt(zdim)
    C = g.standard_normal((centers, zdim)) * 1.5
    r = np.random.default_rng(seed)
    z = C[r.integers(0, centers, n)] + r.standard_normal((n, zdim))
    x = z @ A + 0.05 * r.standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def searched():
    x = unit_manifold(N, 1)
    idx = QuakeIndex(device="cpu")
    idx.build(x, None, IndexBuildParams(metric="ip", nlist=NLIST, precision="bf16",
                                        balance_factor=1.1, calibrate_aps=True))
    assert idx.aps_radius_ab is not None and idx.aps_budget_w > 0
    state = aps.ApsState.of(idx, K)
    s = idx.store.state
    live = torch.nonzero(s.active)[:, 0]
    pst = idx.parent.store.state
    out = []
    for seed in QUERY_SEEDS:
        q = unit_manifold(B, seed)
        res = idx.search(q, SearchParams(k=K, recall_target=TARGET, aps_mode="oneshot"))
        qt = torch.from_numpy(q)
        pids, depth, budget = ref.plan(qt, s.centroids[live], state, TARGET)
        bf16 = ref.plan(qt, s.centroids[live], state, TARGET, precision="bf16")[1]
        ranked = coordinator.rank_parents(pst.codes, pst.ids, pst.norms, qt, state.width, "ip",
                                          idx._parent_kernel()).long()
        out.append(dict(q=qt, res=res, ref_depth=depth.numpy(), ref_budget=budget,
                        bf16_depth=bf16.numpy(), ranked=ranked, ref_pids=live[pids]))
    stored = torch.zeros(N, D)
    owner = torch.full((N,), -1, dtype=torch.int64)
    for p in range(s.ids.shape[0]):
        rows = s.ids[p][:int(s.sizes[p])].long()
        stored[rows] = s.codes[p, :rows.numel()].float()
        owner[rows] = p
    return dict(idx=idx, batches=out, stored=stored, owner=owner, P=int(s.ids.shape[0]),
                C=int(s.codes.shape[1]))


def test_split_centroids_stay_unit_norm(searched):
    idx = searched["idx"]
    assert idx.nlist() > NLIST  # the balancing split clusters
    norms = np.linalg.norm(idx.centroids().astype(np.float64), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


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
    """The port's answers against the exact top-k by q.x over the
    partitions each query scanned: every id one of those rows, its score
    the exact product with the stored row, and the j-th best answer within
    one key step (2 max|q| max|x| / levels) plus the bf16 query's rounding
    on both rows of the j-th best exact score."""
    stored, owner = searched["stored"], searched["owner"]
    slot_mult = max(1 << int(searched["C"] - 1).bit_length(), 2)
    levels = (1 << 24) // slot_mult - 2
    xmax = reference_ip.max_norm(stored)
    hits = total = 0
    for b in searched["batches"]:
        q, res = b["q"].double(), b["res"]
        depth = torch.from_numpy(res.timing_info.scanned_per_query.astype(np.int64))
        scanned = torch.zeros(B, searched["P"], dtype=torch.bool)
        rank = torch.arange(b["ranked"].shape[1])[None, :] < depth[:, None]
        scanned.scatter_(1, b["ranked"], rank)
        full = q @ stored.double().T
        in_plan = scanned[:, owner]
        want_s, want_ids = torch.topk(torch.where(in_plan, full, -torch.inf), K, dim=1)
        got = torch.from_numpy(res.ids)
        assert bool(torch.gather(in_plan, 1, got).all())
        exact = torch.gather(full, 1, got)
        np.testing.assert_allclose(res.distances, exact.numpy(), rtol=0, atol=1e-5)
        hits += int((got[:, :, None] == want_ids[:, None, :]).any(2).sum())
        total += got.numel()
        step = 2.0 * float(q.norm(dim=1).max()) * xmax / levels
        err = U_BF16 * (q.abs() @ stored.double().abs().T).max(dim=1).values
        gap = want_s - torch.sort(exact, dim=1, descending=True).values
        assert bool((gap <= step + 2.0 * err[:, None]).all())
    assert hits / total >= 0.99


@pytest.mark.parametrize("side, refused", [("program", False), ("shallower", True),
                                           ("bf16", True)])
def test_plan_gap_limit(searched, side, refused):
    """plan_gap, the share of rows whose depth differs from the reference's,
    against the ip cell's limit: the program passes; a plan one rounding
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
