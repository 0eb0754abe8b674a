#!/usr/bin/env python3
"""Measure the packaged latency grids of maintenance's cost model on one card.

    python3 scripts/measure_latency_grid.py [--d 128 768] [--check 384] [--out DIR]

Run from the root of a checkout with a CUDA card. For each d of --d it
profiles the default grouped scan (v11: kernels K1 and K2) over the default
grid, n in {1 ... 65536} x k in {1, 4, 16, 64, 256}, in device time
(ListScanLatencyEstimator.profile_grouped_latency: the call captured in a
CUDA graph, CUDA events around 10 replays, the median of 5 trials a point), at
K1's query-tile height for that d as an index profiles it
(QuakeIndex._k1_qt(32)), and writes:

  DIR/h100_grouped_latency_d{d}.csv   the measured grid, in the CSV format
                                      both packages' from_csv read;
  DIR/h100_grouped_latency_d{d}.json  its provenance: the card's name and
                                      power limit, the date, the torch and
                                      CUDA versions, the command as run, the
                                      seconds and the launches (the wrappers
                                      count the warm-up and the captured
                                      calls, not the replays).

DIR defaults to quake_tpu_torch/data, where the package reads its grids.

Each d of --check is measured the same way and written nowhere: it is held
out, to see how far the package's grid for a d without a grid of its own
misses the card. Two models are printed against it, each as the RMS and the
largest relative error over the grid's points, after the monotone
projection: the package's (each point affine in d between the two --d grids
nearest the held-out d, latency_estimator.affine_in_d), and the JAX
package's one-share law L(d) = L(dref) x ((1 - s) + s x d / dref) from the
nearest grid, with s fitted over all points of the two nearest --d grids
(least squares of the relative error).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

DATA_DIR = os.path.join("quake_tpu_torch", "data")


def misses(model: np.ndarray, measured: np.ndarray) -> dict:
    rel = model / measured - 1.0
    return dict(rms_rel_err=float(np.sqrt(np.mean(rel ** 2))), max_rel_err=float(np.abs(rel).max()))


def fit_share(g_ref: np.ndarray, g_d: np.ndarray, ratio_d: float) -> float:
    """s minimizing the squared relative error of g_ref x ((1 - s) + s
    ratio_d) against g_d over the points (linear in s: with u = g_ref / g_d,
    rel = u + s u (ratio_d - 1) - 1)."""
    u = g_ref / g_d
    return float(np.sum(u * (1.0 - u)) / ((ratio_d - 1.0) * np.sum(u * u)))


def measure(torch, d: int) -> tuple:
    """The projected grid at d with its profiling estimator, the seconds,
    the launches and K1's query-tile height."""
    from quake_tpu_torch import _ext
    from quake_tpu_torch.maintenance.latency_estimator import ListScanLatencyEstimator, monotone
    from quake_tpu_torch.ops.grouped import QTS
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_uses_mma

    qt = next((t for t in QTS if t <= 32 and grouped_scan_uses_mma(t, d)), 32)
    est = ListScanLatencyEstimator(d, packaged=False)
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    est.profile_grouped_latency(kernel="v11", qt=qt, device=torch.device("cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _ext.launches.items() if v}
    points = len(est.n_values) * len(est.k_values)
    if set(launches) != {"grouped_scan", "merge_positions"} or min(launches.values()) < points:
        raise AssertionError(f"d={d}: the profile was to run K1 and K2 at each of the "
                             f"{points} points: launches {launches}")
    if not (np.isfinite(est.latency_grid).all() and (est.latency_grid > 0).all()):
        raise AssertionError(f"d={d}: a grid value is not a positive time")
    return est, monotone(est.latency_grid), seconds, launches, qt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d", type=int, nargs="+", default=[128, 768])
    ap.add_argument("--check", type=int, nargs="*", default=[384])
    ap.add_argument("--out", default=DATA_DIR)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("measure_latency_grid: no CUDA device", file=sys.stderr)
        return 1
    from quake_tpu_torch.maintenance.latency_estimator import affine_in_d, monotone

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    command = " ".join(["python3"] + sys.argv)
    os.makedirs(args.out, exist_ok=True)
    grids = {}
    for d in args.d + args.check:
        est, proj, seconds, launches, qt = measure(torch, d)
        raised = int((proj != est.latency_grid).sum())
        if d in args.d:
            base = os.path.join(args.out, f"h100_grouped_latency_d{d}")
            est.save(base + ".csv")
            meta = dict(card=card, device_name=torch.cuda.get_device_name(0),
                        date=datetime.datetime.now(datetime.timezone.utc).isoformat(
                            timespec="seconds"),
                        torch=torch.__version__, cuda=torch.version.cuda, command=command,
                        d=d, kernel="v11", qt=qt, n_queries=1024, n_trials=est.n_trials,
                        seconds=round(seconds, 3), launches=launches,
                        unit="ns per query and probed partition (device time)")
            with open(base + ".json", "w") as f:
                json.dump(meta, f, indent=1)
                f.write("\n")
            grids[d] = proj
        j16 = est.k_values.index(16)
        print(f"[grid] d={d}{' (held out)' if d in args.check else ''} qt={qt} ({card}) "
              f"{seconds:.1f} s, launches {launches}; {raised} points raised by the projection; "
              "L(n, k=16) ns " + ", ".join(f"n={n}: {v:.2f}"
                                           for n, v in zip(est.n_values, proj[:, j16])),
              flush=True)
        if d in args.check and len(grids) >= 2:
            near = sorted(grids, key=lambda dd: abs(np.log(dd / d)))[:2]
            g0, g1 = grids[near[0]], grids[near[1]]
            s = fit_share(grids[min(near)], grids[max(near)], max(near) / min(near))
            law = g0 * ((1.0 - s) + s * d / near[0])
            print(f"[check] d={d} ({card}): affine in d from d={near[0]} and d={near[1]}: "
                  + json.dumps(misses(monotone(affine_in_d(g0, near[0], g1, near[1], d)), proj))
                  + f"; one share s={s:.4f} from d={near[0]}: "
                  + json.dumps(misses(monotone(law), proj)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
