#!/usr/bin/env python3
"""Device times of kernel bodies across shapes, on one card.

    python3 scripts/body_times.py [k2] [k3] [k1] [k7] [multi] [k5] [k6] [k8] [k9] [sized]

Run from the root of a checkout with a CUDA card: the package and
chip_smoke.py are imported from the current directory, so the same script
run from the root of another checkout (an older commit, say) times that
checkout's kernels at the same shapes. With no argument every section runs.

- k2: the pool merge (K2) at the main path's batch (B = 16384, kfin = 10) on
  pools of 90, 91 and 92 columns (the main path's pool is 90 = nprobe 9 x kk
  10), whose rows start 8, 4 and 16 bytes apart.
- k3: K3's CUDA-core body at the parent's shape (B = 16384, N = 256 of which
  160 hold a centroid, k = 9) at D = 13 and 102 (one depth chunk) and 770
  (seven).
- k1: K1's CUDA-core body on 2048 groups of 64 queries over partitions of
  1024 rows at the same depths.
- k7: K7 (chunk_merge) on 2048 groups of 64 queries over 256 partitions of
  C = 7680 rows at D = 128 (sizes drawn between 5000 and 7680: about the main
  index's fill), kk = 10, chunks of ct = 128, 256 and 512 rows.
- multi: multi_topk on the same groups and store, kk = 10, gb = 1 and 8, on
  a full slab (every row holds an id) and a half-occupied one (ids in the
  first half of each partition: the tensor-core body skips the segments
  without one).
- k5: K5 (rowscale_fold, the v7 scan's kernel) on the same groups and store,
  kk = 10, at D = 128 (the tensor-core body) and at D = 127 (the CUDA-core
  body, whose query tile and segments are zero-padded to 128 columns: the
  same products).
- k6: K6 (exact_topk) on the same groups and store, kk = 10, in mode slot
  (lanes below the sizes) and mode id (ids below the sizes, the whole slab
  scanned), at D = 128 and 127 as for k5.
- k8: K8 (raw_scores, the approx scan's kernel) on the same groups and
  store, ids below the sizes (a [2048, 64, 7680] f32 output, 4.0 GB), at
  D = 128 (the tensor-core body) and 127 (the CUDA-core body) as for k5.
- k9: K9 (packed_topk, the packed scan's kernel) on the same, kk = 10.
- sized: sized_topk (the sized scan's kernel) on the same groups and store,
  kk = 10, the lanes below the sizes, at D = 128 and 127 as for k5.

Times come from chip_smoke.py's time_ms. Where the checkout's package names
the body a shape takes, the line says which. A shape the build does not
serve prints the error it raised. Prints one line per shape and the card's
name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from quake_tpu_torch.ops import (grouped_chunked, grouped_exact, grouped_family,  # noqa: E402
                                 grouped_variants)
from quake_tpu_torch.ops.flat_topk import flat_topk  # noqa: E402
from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, merge_positions,  # noqa: E402
                                              packed_params)

B, KFIN, POOLS = 16384, 10, (90, 91, 92)
DEPTHS = (13, 102, 770)
K3_N, K3_VALID, K3_K = 256, 160, 9
K1_P, K1_C, K1_GROUPS, K1_QT, K1_KK = 256, 1024, 2048, 64, 10
# K7 and multi_topk: a store near the main index's (P = 256, C = 7552 there;
# 7680 is divisible by every chunk height), the main path's qt and kk.
SCAN_P, SCAN_C, SCAN_D, SCAN_GROUPS, SCAN_QT, SCAN_KK = 256, 7680, 128, 2048, 64, 10
K7_CTS, MULTI_GBS = (128, 256, 512), (1, 8)
BODY_DEPTHS = (SCAN_D, SCAN_D - 1)  # K5, K6, K8, K9, sized: tensor-core body, CUDA-core one
SECTIONS = ("k2", "k3", "k1", "k7", "multi", "k5", "k6", "k8", "k9", "sized")
BODY_SECTIONS = {"k5", "k6", "k8", "k9", "sized"}


def body_of(module, name: str, *shape) -> str:
    """' (body n)' where the checkout's package has the body query."""
    fn = getattr(module, name, None)
    return f" (body {fn(*shape)})" if fn is not None else ""


def time_k2(dev, rng):
    slot_mult = 256
    for pool in POOLS:
        keys = rng.integers(-1, 2000, size=(B, pool)).astype(np.float32)
        slots = rng.integers(0, slot_mult, size=keys.shape).astype(np.float32)
        mp = torch.from_numpy(np.where(keys >= 0, keys * slot_mult + slots, -1.0)
                              .astype(np.float32)).to(dev)
        ms = chip_smoke.time_ms(torch, lambda: merge_positions(mp, KFIN, slot_mult), reps=50)
        align = min(16, 4 * pool & -(4 * pool))  # bytes every row start is a multiple of
        print(f"K2 B={B} pool={pool} (rows aligned to {align} bytes) kfin={KFIN}: {ms:.4f} ms",
              flush=True)


def time_k3(dev, rng):
    for D in DEPTHS:
        codes = torch.from_numpy(rng.standard_normal((K3_N, D)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
        bias = -(codes * codes).sum(1)
        bias[K3_VALID:] = float("-inf")
        bias = bias.contiguous()
        ms = chip_smoke.time_ms(torch, lambda: flat_topk(codes, bias, q, K3_K, "l2"), reps=20)
        print(f"K3 B={B} N={K3_N} (valid {K3_VALID}) D={D} k={K3_K}: {ms:.4f} ms", flush=True)


def time_k1(dev, rng):
    for D in DEPTHS:
        codes = torch.from_numpy(rng.standard_normal((K1_P, K1_C, D)).astype(np.float32)).to(dev)
        slot_mult1, levels = packed_params(K1_C)
        scale = levels / (10.0 * D ** 0.5)
        normsT = (((codes * codes).sum(-1) * 0.5 - 0.5 * D - 5.0 * D ** 0.5) * scale).contiguous()
        gp = torch.from_numpy(np.sort(rng.integers(0, K1_P, K1_GROUPS)).astype(np.int32)).to(dev)
        gsize = torch.full((K1_GROUPS,), K1_C, dtype=torch.int32, device=dev)
        qg = (torch.randn(K1_GROUPS, K1_QT, D, device=dev) * scale).contiguous()
        args = (gp, gsize, qg, codes, normsT, K1_KK, slot_mult1, levels)
        try:
            ms = chip_smoke.time_ms(torch, lambda: grouped_scan_kernel(*args), reps=5)
            what = f"{ms:.4f} ms"
        except ValueError as e:
            what = f"not served ({e})"
        print(f"K1 groups={K1_GROUPS} qt={K1_QT} C={K1_C} D={D} kk={K1_KK}: {what}", flush=True)


def scan_store(dev, rng):
    """The K7 / multi_topk store and groups: codes, norms, sizes, gp (sorted:
    partition-major, as build_groups makes them) and the query tiles."""
    codes = torch.from_numpy(rng.standard_normal((SCAN_P, SCAN_C, SCAN_D)).astype(np.float32))
    codes = codes.to(dev)
    norms = (codes * codes).sum(-1).contiguous()
    sizes = torch.from_numpy(rng.integers(5000, SCAN_C + 1, SCAN_P).astype(np.int32)).to(dev)
    gp = torch.from_numpy(np.sort(rng.integers(0, SCAN_P, SCAN_GROUPS)).astype(np.int32)).to(dev)
    qg = torch.from_numpy(rng.standard_normal((SCAN_GROUPS, SCAN_QT, SCAN_D))
                          .astype(np.float32)).to(dev)
    return codes, norms, sizes, gp, qg


def time_k7(dev, codes, norms, sizes, gp, qg):
    gsize = sizes[gp.long()].contiguous()
    for ct in K7_CTS:
        slot_mult, levels = packed_params(ct)
        args = (gp, gsize, qg, codes, norms, SCAN_KK, ct, slot_mult, levels, "l2")
        ms = chip_smoke.time_ms(torch, lambda: grouped_chunked.chunk_merge(*args), reps=5)
        print(f"K7 groups={SCAN_GROUPS} qt={SCAN_QT} C={SCAN_C} D={SCAN_D} kk={SCAN_KK} ct={ct}"
              f"{body_of(grouped_chunked, 'chunk_merge_body', SCAN_QT, SCAN_D, SCAN_KK)}: "
              f"{ms:.4f} ms", flush=True)


def time_multi(dev, codes, sizes, gp, qg):
    lane = torch.arange(SCAN_C, device=dev)[None, :]
    ids_all = torch.arange(SCAN_P * SCAN_C, dtype=torch.int32, device=dev).reshape(SCAN_P, SCAN_C)
    for fill, rows in (("full", SCAN_C), ("half", SCAN_C // 2)):
        ids = torch.where(lane < rows, ids_all, torch.full_like(ids_all, -1)).contiguous()
        for gb in MULTI_GBS:
            fn = lambda: grouped_variants.multi_topk(gp, qg, codes, ids, SCAN_KK, "l2", gb=gb)  # noqa: E731
            ms = chip_smoke.time_ms(torch, fn, reps=5)
            print(f"multi_topk groups={SCAN_GROUPS} qt={SCAN_QT} C={SCAN_C} D={SCAN_D} "
                  f"kk={SCAN_KK} gb={gb} slab {fill} ({rows} rows with ids)"
                  f"{body_of(grouped_variants, 'multi_topk_body', SCAN_QT, SCAN_D, SCAN_KK)}: "
                  f"{ms:.4f} ms", flush=True)


def time_bodies(dev, sections, codes, sizes, gp, qg):
    """K5, K6, K8, K9 and sized_topk on their tensor-core body (D = 128)
    and their CUDA-core body (D = 127), whichever sections ask for."""
    gsize = sizes[gp.long()].contiguous()
    lane = torch.arange(SCAN_C, device=dev)[None, :]
    ids = torch.where(lane < sizes[:, None],
                      torch.arange(SCAN_P * SCAN_C, dtype=torch.int32,
                                   device=dev).reshape(SCAN_P, SCAN_C), -1).contiguous()
    slot_mult, levels = packed_params(SCAN_C)
    for D in BODY_DEPTHS:
        cd = codes if D == SCAN_D else codes[..., :D].contiguous()
        qd = qg if D == SCAN_D else qg[..., :D].contiguous()
        nd = (cd * cd).sum(-1).contiguous()
        shape = f"groups={SCAN_GROUPS} qt={SCAN_QT} C={SCAN_C} D={D} kk={SCAN_KK}"
        if "k5" in sections:
            args = (gp, gsize, qd, cd, nd, SCAN_KK, slot_mult, levels, "l2", "fold")
            ms = chip_smoke.time_ms(torch, lambda: grouped_family.rowscale_scan(*args), reps=5)
            print(f"K5 {shape}{body_of(grouped_family, 'rowscale_fold_body', SCAN_QT, D, SCAN_KK)}"
                  f": {ms:.4f} ms", flush=True)
        if "k8" in sections:
            fn = lambda: grouped_variants.raw_scores(gp, qd, cd, ids, "l2")  # noqa: E731
            ms = chip_smoke.time_ms(torch, fn, reps=5)
            print(f"K8 {shape}{body_of(grouped_variants, 'raw_scores_body', SCAN_QT, D)}: "
                  f"{ms:.4f} ms", flush=True)
        if "k9" in sections:
            fn = lambda: grouped_variants.packed_topk(gp, qd, cd, ids, SCAN_KK, "l2")  # noqa: E731
            ms = chip_smoke.time_ms(torch, fn, reps=5)
            print(f"K9 {shape}"
                  f"{body_of(grouped_variants, 'packed_topk_body', SCAN_QT, D, SCAN_KK)}: "
                  f"{ms:.4f} ms", flush=True)
        if "sized" in sections:
            fn = lambda: grouped_variants.sized_topk(gp, gsize, qd, cd, SCAN_KK, "l2")  # noqa: E731
            ms = chip_smoke.time_ms(torch, fn, reps=5)
            print(f"sized_topk {shape}"
                  f"{body_of(grouped_variants, 'sized_topk_body', SCAN_QT, D, SCAN_KK)}: "
                  f"{ms:.4f} ms", flush=True)
        if "k6" in sections:
            for mode, kw in (("slot", dict(group_size=gsize, norms=nd)), ("id", dict(ids=ids))):
                fn = lambda: grouped_exact.exact_scan(gp, qd, cd, SCAN_KK, "l2", mode, **kw)  # noqa: E731
                ms = chip_smoke.time_ms(torch, fn, reps=5)
                print(f"K6 mode {mode} {shape}"
                      f"{body_of(grouped_exact, 'exact_topk_body', SCAN_QT, D, SCAN_KK)}: "
                      f"{ms:.4f} ms", flush=True)
        del cd, qd, nd


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("body_times: no CUDA device", file=sys.stderr)
        return 1
    sections = argv or list(SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        print(f"body_times: unknown sections {sorted(unknown)}; choose from {SECTIONS}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if "k2" in sections:
        time_k2(dev, rng)
    if "k3" in sections:
        time_k3(dev, rng)
    if "k1" in sections:
        time_k1(dev, rng)
    if ({"k7", "multi"} | BODY_SECTIONS) & set(sections):
        codes, norms, sizes, gp, qg = scan_store(dev, np.random.default_rng(1))
        if "k7" in sections:
            time_k7(dev, codes, norms, sizes, gp, qg)
        if "multi" in sections:
            time_multi(dev, codes, sizes, gp, qg)
        if BODY_SECTIONS & set(sections):
            time_bodies(dev, sections, codes, sizes, gp, qg)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
