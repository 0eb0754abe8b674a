#!/usr/bin/env python3
"""Device times of the pool merge (K2) across pool widths, and of the
CUDA-core bodies of K1 and K3 (D % 4 != 0) across depths, on one card.

    python3 scripts/body_times.py

Run from the repository root on a machine with a CUDA card. K2 is timed at
the main path's batch (B = 16384, kfin = 10) on pools of 90, 91 and 92
columns (the main path's pool is 90 = nprobe 9 x kk 10), whose rows start
8, 4 and 16 bytes apart. K3's CUDA-core body is timed at the parent's shape
(B = 16384, N = 256 of which 160 hold a centroid, k = 9) at D = 13 and 102
(one depth chunk) and 770 (seven). K1's CUDA-core body is timed on 2048
groups of 64 queries over partitions of 1024 rows at the same depths. Times
come from chip_smoke.py's time_ms. A shape the build does not serve prints
the error it raised. Prints one line per shape and the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from quake_tpu_torch.ops.flat_topk import flat_topk  # noqa: E402
from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, merge_positions,  # noqa: E402
                                              packed_params)

B, KFIN, POOLS = 16384, 10, (90, 91, 92)
DEPTHS = (13, 102, 770)
K3_N, K3_VALID, K3_K = 256, 160, 9
K1_P, K1_C, K1_GROUPS, K1_QT, K1_KK = 256, 1024, 2048, 64, 10


def main() -> int:
    if not torch.cuda.is_available():
        print("body_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
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
    for D in DEPTHS:
        codes = torch.from_numpy(rng.standard_normal((K3_N, D)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
        bias = -(codes * codes).sum(1)
        bias[K3_VALID:] = float("-inf")
        bias = bias.contiguous()
        ms = chip_smoke.time_ms(torch, lambda: flat_topk(codes, bias, q, K3_K, "l2"), reps=20)
        print(f"K3 B={B} N={K3_N} (valid {K3_VALID}) D={D} k={K3_K}: {ms:.4f} ms", flush=True)
        del codes, q, bias
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
        del codes, normsT, qg
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
