#!/usr/bin/env python3
"""Where a recall-target (APS) batch spends its device time, on one card.

    python3 scripts/aps_breakdown.py

Run from the root of a checkout with a CUDA card. Builds chip_smoke.py's APS
index (its 1M x 128 corpus, nlist=1024, default IndexBuildParams: APS
calibrated) and, for each aps_mode of chip_smoke.APS_MODES and the
fixed-nprobe anchor at nprobe 32, traces 5 batches of B = 4096 queries with
torch.profiler: the device time of each kernel a batch (the 12 largest, the
rest summed), the device's busy time a batch (the kernels' device time
summed; one stream, so they do not overlap), the host clock a batch after a
synchronize, and the idle share 1 - busy / host. Prints one JSON line a
mode; where the profiler records no device time it says so and prints
none.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

REPS = 5


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.profiling import device_summary

    if not torch.cuda.is_available():
        print("aps_breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    x = cs.make_manifold(cs.N, cs.D, 4096, seed=1)
    queries = cs.make_manifold(cs.APS_BATCH, cs.D, 4096, seed=7)
    idx = QuakeIndex()
    idx.build(x, np.arange(cs.N, dtype=np.int64), IndexBuildParams(nlist=cs.APS_NLIST))
    del x
    q = torch.from_numpy(queries).cuda()
    runs = {mode: SearchParams(k=cs.K, recall_target=cs.APS_TARGET, aps_mode=mode)
            for mode in cs.APS_MODES}
    runs["fixed nprobe 32"] = SearchParams(k=cs.K, nprobe=32)
    for name, sp in runs.items():
        for _ in range(3):
            idx._search_device_full(q, sp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                idx._search_device_full(q, sp)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        busy, kernels = device_summary(prof, REPS)
        if busy <= 0:
            print(json.dumps({"mode": name, "card": card, "device_time": "not measured: the "
                              "profiler recorded no device time", "host_ms": host_ms}))
            continue
        top = kernels[:12]
        print(json.dumps({"mode": name, "card": card, "host_ms": host_ms, "busy_ms": busy,
                          "idle_share": max(0.0, 1.0 - busy / host_ms),
                          "kernels_ms": {k: round(v, 4) for k, v in top},
                          "other_kernels_ms": round(busy - sum(v for _, v in top), 4)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
