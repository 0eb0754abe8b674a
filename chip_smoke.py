#!/usr/bin/env python3
"""Full-width run of quake_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. card    — needs torch.cuda; prints nvidia-smi's name and power limit.
2. build   — compiles the CUDA kernels from quake_tpu_torch/csrc with nvcc.
3. parity  — holds kernels K1 (grouped scan), K2 (pool merge) and K3 (parent
             ranking) against their plain PyTorch versions on the card at
             small shapes.
4. main    — the fixed-nprobe main path at full width: a 1,000,000 x 128
             synthetic-manifold corpus (seed 1), nlist=160, niter=25, l2, f32
             codes, built and searched through QuakeIndex. Recall@10 on 1024
             queries against an exact ground truth on the card picks the
             smallest nprobe reaching 0.90; batches of B=16384 (argsort
             placement) and B=4096 (sorted placement) are then timed with
             CUDA events, with a per-stage breakdown. The kernels' launch
             counts are zeroed just before this phase and read just after it.
5. check   — the results are finite and of the expected shape, and a small
             index searched on the card agrees with the same store searched
             on the CPU through the plain versions.
6. kernels — each kernel against its plain version again, at the shapes the
             main path gave it, with times and bounds.

Progress goes to stderr. Standard output holds three lines: the JSON list
of kernels, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

K, NLIST, NITER, N, D = 10, 160, 25, 1_000_000, 128
NQ_GT, BATCH, BATCH_SORTED = 1024, 16384, 4096
NPROBE_GRID = (9, 10, 11, 12, 14, 16, 24, 48)
RECALL_GATE = 0.90
OVERLAP_TOL = 0.99  # K1, K3: winner overlap with the plain version
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM bytes/s
SOURCE = "quake_tpu_torch/csrc/quake_kernels.cu"
REPLACES = {
    "grouped_scan": "quake_tpu/ops/pallas_grouped.py:1180",
    "merge_positions": "quake_tpu/ops/pallas_grouped.py:994",
    "flat_topk": "quake_tpu/ops/pallas_flat.py:32",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_manifold(n, d, n_centers, seed, zdim=16, spread=1.5):
    """SIFT-like synthetic: clustered data on a low-dimensional manifold
    embedded in d dims (the benchmark family of the JAX package)."""
    rng = np.random.default_rng(99)  # shared manifold/centers across calls
    A = rng.standard_normal((zdim, d)).astype(np.float32) / np.sqrt(zdim)
    centers = rng.standard_normal((n_centers, zdim)).astype(np.float32) * spread
    r = np.random.default_rng(seed)
    z = centers[r.integers(0, n_centers, n)] + r.standard_normal((n, zdim)).astype(np.float32)
    return (z @ A + 0.05 * r.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def bound(nbytes: float, flops: float):
    """Least time (ms) the card needs for the work, and what sets it."""
    tb, tf = nbytes / HBM_RATE, flops / F32_PEAK
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def overlap(a, b) -> float:
    """Mean over rows of the share of b's winners (>= 0) that a also has."""
    tot = 0.0
    for ra, rb in zip(a.tolist(), b.tolist()):
        sa, sb = {v for v in ra if v >= 0}, {v for v in rb if v >= 0}
        tot += len(sa & sb) / len(sb) if sb else float(not sa)
    return tot / max(len(a), 1)


def exact_gt(torch, x_dev, q_dev, k: int, chunk: int = 1 << 18):
    """Exact l2 top-k ids by brute force on the card (f32, no TF32)."""
    best_s = best_i = None
    for c0 in range(0, x_dev.shape[0], chunk):
        xc = x_dev[c0:c0 + chunk]
        s = 2.0 * (q_dev @ xc.T) - (xc * xc).sum(1)[None, :]
        sv, si = torch.topk(s, k, dim=1)
        si = si + c0
        if best_s is not None:
            sv, j = torch.topk(torch.cat([best_s, sv], 1), k, dim=1)
            si = torch.gather(torch.cat([best_i, si], 1), 1, j)
        best_s, best_i = sv, si
    return best_i.cpu().numpy()


# ------------------------------------------------------------------ phases


def phase_small_parity(torch, dev):
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_plain
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  merge_positions, merge_positions_plain,
                                                  packed_params)

    rng = np.random.default_rng(0)
    P, C, Dm, Gn, qt, kk = 6, 256, 32, 24, 32, 10
    codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    sizes = torch.tensor([256, 200, 0, 17, 130, 256], dtype=torch.int32, device=dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    slot_mult, levels = packed_params(C)
    scale = levels / 200.0
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32) * scale).to(dev)
    normsT = (((codes * codes).sum(-1) * 0.5 - 100.0) * scale).contiguous()
    k1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, gp, gsize.contiguous(),
                    qg, codes, normsT, kk, slot_mult, levels)
    keys = rng.integers(-1, 500, size=(500, 256)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.4] = -1.0
    keys = torch.from_numpy(keys).to(dev)
    k2 = compare_k2(torch, merge_positions, merge_positions_plain, keys, 10, 256)
    cb = torch.from_numpy(rng.standard_normal((384, Dm)).astype(np.float32)).to(dev)
    qb = torch.from_numpy(rng.standard_normal((500, Dm)).astype(np.float32)).to(dev)
    bias = (-(cb * cb).sum(1)).contiguous()
    bias[-20:] = float("-inf")
    k3 = compare_k3(torch, flat_topk, flat_topk_plain, cb, bias, qb, 16, "l2")
    log(f"[parity small] K1 overlap={k1[0]:.4f} max_key_diff={k1[1]}; K2 equal; "
        f"K3 overlap={k3[0]:.4f} max_key_diff={k3[1]}")


def compare_k1(torch, kernel, plain, gp, gsize, qg, codes, normsT, kk, slot_mult, levels):
    got = kernel(gp, gsize, qg, codes, normsT, kk, slot_mult, levels)
    want = plain(gp, gsize, qg, codes, normsT, kk, slot_mult, levels)
    torch.cuda.synchronize()
    alive = gsize > 0
    if not bool((got[~alive] == -1).all()):
        raise AssertionError("K1: ghost groups must be all -1")
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    lanes = [torch.where(t >= 0, torch.remainder(t, slot_mult), torch.full_like(t, -1))
             for t in (g, w)]
    ov = overlap(lanes[0], lanes[1])
    both = (g >= 0) & (w >= 0)
    kd = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    max_kd = float(kd[both].max()) if bool(both.any()) else 0.0
    if ov < OVERLAP_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: overlap {ov}")
    return ov, max_kd


def compare_k2(torch, kernel, plain, keys, kfin, lane_mult):
    got = kernel(keys, kfin, lane_mult)
    want = plain(keys, kfin, lane_mult)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 disagrees with its plain version (must be equal)")
    return 0.0


def compare_k3(torch, kernel, plain, codes2d, bias, q, k, metric):
    from quake_tpu_torch.ops.flat_topk import _packed_params

    got = kernel(codes2d, bias, q, k, metric)
    want = plain(codes2d, bias, q, k, metric)
    torch.cuda.synchronize()
    ov = overlap(got, want)
    if ov < OVERLAP_TOL:
        raise AssertionError(f"K3 disagrees with its plain version: overlap {ov}")
    # Quantized key (plain arithmetic) of each rank's pick, kernel vs plain.
    _, levels = _packed_params(codes2d.shape[0])
    prod = q @ codes2d.T
    s = (2.0 * prod if metric == "l2" else prod) + bias[None, :]
    valid = s > float("-inf")
    mx = torch.where(valid, s, torch.full_like(s, float("-inf"))).amax(1, keepdim=True)
    mn = torch.where(valid, s, torch.full_like(s, float("inf"))).amin(1, keepdim=True)
    key = torch.floor((s - mn) * (levels / torch.clamp(mx - mn, min=1e-20)))
    both = (got >= 0) & (want >= 0)
    kg = torch.gather(key, 1, got.clamp(min=0).long())
    kw = torch.gather(key, 1, want.clamp(min=0).long())
    max_kd = float((kg - kw).abs()[both].max()) if bool(both.any()) else 0.0
    return ov, max_kd


def phase_main(torch, dev, x, queries):
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.ops.grouped import group_layout
    from quake_tpu_torch.ops.grouped_scan import sort_key_fits
    from quake_tpu_torch.profiling import StageTimer
    from quake_tpu_torch.utils import compute_recall

    out = {}
    t0 = time.perf_counter()
    idx = QuakeIndex(device=dev)
    bt = idx.build(x, np.arange(N, dtype=np.int64),
                   IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER, calibrate_aps=False))
    out["build_s"] = time.perf_counter() - t0
    st = idx.store.state
    out["store_bytes"] = sum(t.numel() * t.element_size()
                             for t in (st.codes, st.ids, st.norms, st.sizes))
    out.update(P=idx.store.P, C=idx.store.C, nlist=idx.nlist(),
               train_s=bt.train_time_us / 1e6, assign_s=bt.assign_time_us / 1e6)
    log(f"[main] build {out['build_s']:.2f} s (train {out['train_s']:.2f} s, store "
        f"{out['assign_s']:.2f} s): nlist={out['nlist']} P={out['P']} C={out['C']} "
        f"store={out['store_bytes'] / 1e9:.3f} GB")

    x_dev = torch.from_numpy(x).to(dev)
    q_gt = queries[:NQ_GT]
    gt = exact_gt(torch, x_dev, torch.from_numpy(q_gt).to(dev), K)
    del x_dev
    chosen = None
    for nprobe in NPROBE_GRID:
        res = idx.search(q_gt, SearchParams(k=K, nprobe=nprobe))
        r = compute_recall(res.ids, gt, K)
        log(f"[main] nprobe={nprobe} recall@10={r:.4f}")
        if r >= RECALL_GATE:
            chosen = (nprobe, r, res)
            break
    if chosen is None:
        raise AssertionError(f"no nprobe in {NPROBE_GRID} reaches recall {RECALL_GATE}")
    nprobe, recall, res = chosen
    out.update(nprobe=nprobe, recall=recall)
    if res.ids.shape != (NQ_GT, K) or not np.isfinite(res.distances[res.ids >= 0]).all():
        raise AssertionError("search results have the wrong shape or non-finite distances")

    sp = SearchParams(k=K, nprobe=nprobe)
    for B, placement in ((BATCH, "argsort"), (BATCH_SORTED, "sorted")):
        qt = idx._grouped_params(B, nprobe)
        gpb = int(idx._grouped_kernel()[len("v11g"):])
        rows = -(-group_layout(B, nprobe, idx.store.P, qt) // gpb) * gpb * qt
        if ("sorted" if sort_key_fits(B, rows) else "argsort") != placement:
            raise AssertionError(f"B={B} was expected to take the {placement} placement")
        qd = torch.from_numpy(queries[:B]).to(dev)
        ms = time_ms(torch, lambda: idx._search_device_full(qd, sp), reps=10)
        timer = StageTimer(dev)
        for _ in range(3):
            idx._search_device_full(qd, sp, stages=timer)
        stages = timer.mean_ms()
        _, ids32, _, dists = idx._search_device_full(qd, sp)
        ids_np = ids32.cpu().numpy()
        if ids_np.shape != (B, K) or (ids_np < 0).any():
            raise AssertionError(f"B={B}: expected {K} ids per query")
        if not torch.isfinite(dists).all():
            raise AssertionError(f"B={B}: non-finite distances")
        r_b = compute_recall(ids_np[:NQ_GT], gt, K)
        out[f"B{B}"] = dict(ms=ms, qps=B / (ms / 1e3), recall_first_1024=r_b,
                            placement=placement, qt=qt, stages_ms=stages)
        log(f"[main] B={B} ({placement} placement, qt={qt}): {ms:.3f} ms/batch, {B / (ms / 1e3):,.0f} QPS, recall(first "
            f"1024)={r_b:.4f}, stages(ms)={json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    return idx, out


def phase_small_reference(torch, dev):
    """A small index searched on the card agrees with the same store
    searched on the CPU (plain versions of every kernel)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy

    x = make_manifold(20_000, 32, 256, seed=3)
    q = make_manifold(512, 32, 256, seed=4)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=64, calibrate_aps=False))
    arrays = [{f: getattr(s.store.state, f).cpu().numpy()
               for f in ("codes", "ids", "sizes", "centroids", "active", "norms")}
              for s in (idx, idx.parent)]
    cpu = index_from_numpy(arrays[0], arrays[1], "l2", device="cpu")
    sp = SearchParams(k=K, nprobe=8)
    a, b = idx.search(q, sp), cpu.search(q, sp)
    ov = overlap(torch.from_numpy(a.ids), torch.from_numpy(b.ids))
    if ov < OVERLAP_TOL:
        raise AssertionError(f"card and CPU searches disagree: overlap {ov}")
    log(f"[check] small index, card vs CPU plain path: id overlap {ov:.4f}")
    return ov


def phase_kernels(torch, dev, idx, queries, nprobe, launches):
    """Each kernel against its plain version at the main path's shapes, with
    times and bounds."""
    from quake_tpu_torch.coordinator import rank_parents
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_plain, parent_bias
    from quake_tpu_torch.ops.grouped_scan import (argsort_placement, grouped_scan_kernel,
                                                  grouped_scan_plain, merge_positions,
                                                  merge_positions_plain, pool_keys, v11_inputs)

    st, pst = idx.store.state, idx.parent.store.state
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    rows = []

    # K3 at the parent ranking's shape.
    Pp, Cp, Dd = pst.codes.shape
    codes2d = pst.codes.reshape(Pp * Cp, Dd).contiguous()
    bias = parent_bias(pst.ids, pst.norms, "l2")
    ov3, kd3 = compare_k3(torch, flat_topk, flat_topk_plain, codes2d, bias, q, nprobe, "l2")
    n_valid = int((pst.ids >= 0).sum())
    b3 = bound((q.numel() + codes2d.numel() + bias.numel() + BATCH * nprobe) * 4,
               2.0 * BATCH * n_valid * Dd)
    rows.append(dict(name="flat_topk", tol=f"winner overlap >= {OVERLAP_TOL}", overlap=ov3,
                     max_abs_err=kd3,
                     ms=time_ms(torch, lambda: flat_topk(codes2d, bias, q, nprobe, "l2")),
                     plain_ms=time_ms(torch, lambda: flat_topk_plain(codes2d, bias, q, nprobe, "l2")),
                     bound=b3))

    # K1 at the grouped scan's shape.
    pids = rank_parents(pst.codes, pst.ids, pst.norms, q, nprobe, "l2")
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    qt = idx._grouped_params(BATCH, nprobe)
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    inp = v11_inputs(st.codes, st.sizes, st.norms, q, pids, K, "l2", qt, gpb)
    args = (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], inp["kk"],
            inp["slot_mult"], inp["levels"])
    ov1, kd1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, *args)
    gs = inp["group_size"].long()
    alive = gs > 0
    seg_rows = ((gs + 127) // 128) * 128
    used = torch.unique(inp["gp"][alive].long())
    read_rows = int((((st.sizes[used].long() + 127) // 128) * 128).sum())
    real_q = (inp["tgt"] < BATCH * nprobe).sum(1)  # query rows that are real pairs
    flops1 = 2.0 * Dd * float((real_q[alive] * gs[alive]).sum())
    bytes1 = (inp["qg"].numel() * 4 + read_rows * (Dd + 1) * 4 + inp["gp"].numel() * 8
              + inp["gp"].numel() * qt * inp["kk"] * 4)
    rows.append(dict(name="grouped_scan", tol=f"winner overlap >= {OVERLAP_TOL}", overlap=ov1,
                     max_abs_err=kd1, ms=time_ms(torch, lambda: grouped_scan_kernel(*args)),
                     plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args), reps=2, warmup=1),
                     bound=bound(bytes1, flops1),
                     groups=int(alive.sum()), scanned_rows=int(seg_rows[alive].sum())))

    # K2 at the pool merge's shape (argsort placement of the B=16384 batch).
    g_packed = grouped_scan_kernel(*args)
    m_packed, _ = argsort_placement(g_packed, inp["tgt"], inp["group_size"], pids)
    mk, lane_mult = pool_keys(m_packed, inp["slot_mult"])
    kfin = min(K, m_packed.shape[1])
    compare_k2(torch, merge_positions, merge_positions_plain, mk, kfin, lane_mult)
    bytes2 = (mk.numel() + BATCH * kfin) * 4
    rows.append(dict(name="merge_positions", tol="equal", overlap=1.0, max_abs_err=0.0,
                     ms=time_ms(torch, lambda: merge_positions(mk, kfin, lane_mult)),
                     plain_ms=time_ms(torch, lambda: merge_positions_plain(mk, kfin, lane_mult)),
                     bound=bound(bytes2, 0.0)))

    kernels = []
    for r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), overlap {r['overlap']:.4f}, "
            f"max key diff {r['max_abs_err']} ({r['tol']}), launches on the main path "
            f"{launches[r['name']]}" + (f", groups {r['groups']}, scanned rows "
                                       f"{r['scanned_rows']}" if "groups" in r else ""))
        kernels.append({"name": r["name"], "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    from quake_tpu_torch import _ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _ext.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_ext.library_path().name})")

    phase_small_parity(torch, dev)

    t0 = time.perf_counter()
    x = make_manifold(N, D, 4096, seed=1)
    queries = make_manifold(BATCH, D, 4096, seed=7)
    log(f"[data] {N} x {D} corpus + {BATCH} queries in {time.perf_counter() - t0:.2f} s")

    _ext.reset_launches()
    idx, main_out = phase_main(torch, dev, x, queries)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    log(f"[main] kernel launches on the main path: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    phase_small_reference(torch, dev)
    kernels = phase_kernels(torch, dev, idx, queries, main_out["nprobe"], launches)
    log("[summary] " + json.dumps(main_out))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
