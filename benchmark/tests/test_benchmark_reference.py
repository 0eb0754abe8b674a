"""The plain reference against brute force in numpy on tiny cases, and its
judgements on planted faults."""

import numpy as np
import torch

from benchmark import reference


def _case(seed=0, n=500, d=16, m=20):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g), torch.randn(m, d, generator=g)


def test_exact_knn_matches_numpy_brute_force():
    x, q = _case()
    ids, dist = reference.exact_knn(q, x, 10, b_block=128, q_block=7)
    d2 = ((q.numpy()[:, None, :].astype(np.float64) - x.numpy()[None].astype(np.float64)) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :10]
    assert (ids.numpy() == want).all()
    np.testing.assert_allclose(dist.numpy() ** 2, np.take_along_axis(d2, want, 1), rtol=1e-12)


def test_exact_knn_over_the_valid_rows_only():
    x, q = _case(1)
    valid = torch.zeros(x.shape[0], dtype=torch.bool)
    valid[::3] = True
    ids, _ = reference.exact_knn(q, x, 5, valid=valid, b_block=64)
    assert bool(valid[ids].all())
    sub = torch.nonzero(valid)[:, 0]
    ids2, _ = reference.exact_knn(q, x[sub], 5)
    assert (sub[ids2] == ids).all()


def test_rounding():
    v = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -11])
    assert reference.round_to(v, "tf32")[0] == 1.0
    assert reference.round_to(v, "tf32")[1] == 1.0 + 2 ** -10
    assert reference.round_to(v, "f32").equal(v)
    assert reference.round_to(torch.tensor([1.03]), "fp8")[0] == 1.0


def test_dist_err_and_invalid_answers():
    x, q = _case(2)
    ids, dist = reference.exact_knn(q, x, 10)
    alive = torch.ones(x.shape[0], dtype=torch.bool)
    assert reference.dist_err(q, x, ids, dist) < 1e-12
    assert reference.invalid_answers(ids, dist, alive, 10) == 0
    assert reference.recall(ids, ids, 10) == 1.0
    # An answer altered where it is produced: another id, the same distance.
    bad = ids.clone()
    bad[0, 0] = ids[1, 9]
    assert reference.dist_err(q, x, bad, dist) > 1e-3
    # A row left out (-1), a dead id, a repeated id, a falling distance.
    empty = ids.clone()
    empty[3] = -1
    assert reference.invalid_answers(empty, dist, alive, 10) == 10
    dead = alive.clone()
    dead[ids[4, 2]] = False
    assert reference.invalid_answers(ids, dist, dead, 10) == int((ids == ids[4, 2]).sum())
    twice = ids.clone()
    twice[5, 1] = twice[5, 0]
    assert reference.invalid_answers(twice, dist, alive, 10) == 1
    assert reference.invalid_answers(ids, dist.flip(1), alive, 10) == q.shape[0] * 9


def _store(x, parts=3, C=256, dtype=torch.float32):
    n = x.shape[0]
    a = torch.arange(n) % parts
    codes = torch.zeros(parts, C, x.shape[1], dtype=dtype)
    ids = torch.full((parts, C), -1, dtype=torch.int32)
    sizes = torch.zeros(parts, dtype=torch.int32)
    for p in range(parts):
        rows = torch.nonzero(a == p)[:, 0]
        codes[p, :len(rows)] = x[rows].to(dtype)
        ids[p, :len(rows)] = rows.to(torch.int32)
        sizes[p] = len(rows)
    norms = (codes.float() ** 2).sum(-1)
    return codes, ids, sizes, norms


def test_store_checks():
    x, _ = _case(3, n=600)
    alive = torch.ones(600, dtype=torch.bool)
    for dt in (torch.float32, torch.bfloat16):
        codes, ids, sizes, norms = _store(x, dtype=dt)
        assert reference.store_violations(codes, ids, sizes, x, alive, dt) == 0
        assert reference.norm_err(norms, ids, sizes, x, dt) < 1e-6
    codes, ids, sizes, norms = _store(x)
    lost = sizes.clone()
    lost[0] -= 1  # an acknowledged vector gone
    assert reference.store_violations(codes, ids, lost, x, alive, torch.float32) == 2
    ghost = alive.clone()
    ghost[7] = False  # a deleted id still held
    assert reference.store_violations(codes, ids, sizes, x, ghost, torch.float32) == 1
    moved = codes.clone()
    moved[1, 0, 0] += 1.0
    assert reference.store_violations(moved, ids, sizes, x, alive, torch.float32) == 1
    assert reference.norm_err(norms * 1.001, ids, sizes, x, torch.float32) > 5e-4
    assert reference.norm_err(norms, ids, sizes, x, torch.float32, "tf32") > 1e-5


def test_assignment_gap_and_probes():
    x, c = _case(4, n=300, m=12)
    near = reference.nearest_centroid(x, c)
    assert reference.assign_gap(x, near, c) <= 1e-12
    other = (near + 1) % c.shape[0]
    assert reference.assign_gap(x, other, c) > 1e-3
    probes, _ = reference.certain_probes(x[:5], c, 3)
    assert (probes[:, 0] == near[:5]).all()


def _parts(x, c):
    """Rows put in their nearest centroid's partition, in row order."""
    near = reference.nearest_centroid(x, c)
    return [torch.nonzero(near == p)[:, 0] for p in range(c.shape[0])]


def test_probed_topk_matches_numpy_over_the_surely_probed_rows():
    x, q = _case(5, n=800, m=25)
    c = x[:10] + 0.01
    parts = _parts(x, c)
    probes, certain = reference.certain_probes(q, c, 3)
    ids, d2 = reference.probed_topk(q, x, parts, probes, certain, 5, r_block=7)
    xd, qd = x.numpy().astype(np.float64), q.numpy().astype(np.float64)
    for i in range(q.shape[0]):
        rows = np.concatenate([parts[p].numpy() for p, ok in zip(probes[i].tolist(),
                                                                  certain[i].tolist()) if ok])
        dist = ((qd[i] - xd[rows]) ** 2).sum(-1)
        order = np.argsort(dist, kind="stable")[:5]
        assert (ids[i].numpy() == rows[order]).all()
        np.testing.assert_allclose(d2[i].numpy(), dist[order], rtol=1e-12)


def test_certain_probes_leave_out_a_near_tie():
    c = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [2.0, 1e-7]])
    q = torch.tensor([[0.0, 0.5], [1.0, 0.0]])
    probes, certain = reference.certain_probes(q, c, 2)
    assert probes[0].tolist() == [0, 1] and certain[0].all()
    # The second query's second probe ties with the third centroid.
    assert probes[1, 0] == 1 and bool(certain[1, 0])
    assert not bool(certain[1, 1])


def test_selection_budget_reads_a_key_selection_under_one_and_a_wrong_one_over():
    x, q = _case(6, n=2000, m=40)
    c = x[:12] + 0.01
    parts = _parts(x, c)
    probes, certain = reference.certain_probes(q, c, 4)
    best, best_d2 = reference.probed_topk(q, x, parts, probes, certain, 10)
    cap = 1 << 18  # 62 levels: a step coarse enough to reorder near ties
    floor, step = reference.key_scale(q, x, cap)
    floor = torch.full((q.shape[0],), floor, dtype=torch.float64)
    step = torch.full((q.shape[0],), step, dtype=torch.float64)
    rank = reference.keyed_rank(floor, step, "f32", cap)
    keyed, _ = reference.probed_topk(q, x, parts, probes, certain, 10, rank=rank)
    assert not (keyed == best).all()  # the key's step reorders near ties
    assert reference.sel_budget(q, x, best, best, best_d2, step[:, None], "f32") <= 0.0
    assert 0.0 < reference.sel_budget(q, x, keyed, best, best_d2, step[:, None], "f32") < 1.0
    # The 10th nearest swapped for the 30th of the probed rows; a row left short.
    far, _ = reference.probed_topk(q, x, parts, probes, certain, 30)
    wrong = best.clone()
    wrong[:, 9] = far[:, 29]
    assert reference.sel_budget(q, x, wrong, best, best_d2, step[:, None], "f32") > 1.0
    short = best.clone()
    short[0, 9] = -1
    assert reference.sel_budget(q, x, short, best, best_d2, step[:, None], "f32") == float("inf")
