"""Partition-scan latency model for maintenance cost estimation (the
counterpart of quake_tpu/maintenance/latency_estimator.py).

Mirrors the reference ListScanLatencyEstimator
(src/cpp/include/maintenance_cost_estimator.h,
src/cpp/src/maintenance_cost_estimator.cpp:126-365): a grid of latencies over
n in {1..65536} x k in {1..256}, bilinear interpolation inside the grid,
linear extrapolation beyond it, CSV save and load in the JAX package's bytes
(either package loads what the other saved).

Two sources for the grid values:
  * analytic (the default): the JAX package's byte/overhead model with its
    constants, so that the same hit window makes the same decisions in both
    packages;
  * profiled: the index's own grouped scan timed over the grid
    (`profile_grouped_latency`; on a CUDA index kernel K1 with K2), like the
    reference's empirical grid (maintenance_cost_estimator.cpp:59-94).
The JAX package's packaged grid holds another device's measurements and is
not carried over: `packaged=True` raises.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from quake_tpu_torch.params import (
    DEFAULT_LATENCY_ESTIMATOR_NTRIALS,
    DEFAULT_LATENCY_ESTIMATOR_RANGE_K,
    DEFAULT_LATENCY_ESTIMATOR_RANGE_N,
)

PACKAGED_GRID = "ROADMAP Queue 1 item 12: a packaged grid measured on the H100"

# The analytic model's constants (the JAX package's values): a partition of
# n rows costs (0.9 x its 256-row padded capacity + 0.1 n + one tile of
# overhead rows) x d x 4 bytes at _MODEL_BYTES_PER_NS, plus _PER_K_NS a
# result. With alpha = 0.9 splitting breaks even near 8 tiles (~2048 rows).
_MODEL_BYTES_PER_NS = 800.0
_TILE_OVERHEAD_ROWS = 256.0
_PER_K_NS = 2.0


class ListScanLatencyEstimator:
    def __init__(
        self,
        d: int,
        n_values=None,
        k_values=None,
        n_trials: int = DEFAULT_LATENCY_ESTIMATOR_NTRIALS,
        packaged: bool | None = None,
    ):
        if packaged:
            raise NotImplementedError(f"packaged=True is not ported yet ({PACKAGED_GRID})")
        self.d = int(d)
        self.n_values = list(n_values or DEFAULT_LATENCY_ESTIMATOR_RANGE_N)
        self.k_values = list(k_values or DEFAULT_LATENCY_ESTIMATOR_RANGE_K)
        self.n_trials = int(n_trials)
        self.latency_grid = self._analytic_grid()
        # Provenance of the grid: "analytic", "profiled" (timed on this
        # index's device) or "csv" (loaded from a saved profile).
        self.grid_source = "analytic"

    # -- grid construction -----------------------------------------------------

    def _analytic_latency(self, n: float, k: float) -> float:
        # A step at every 256-row capacity tile, with a small term in the
        # true size so that L stays strictly increasing between the steps
        # (maintenance_cost_estimator.cpp:384-493 takes differences of L).
        padded = max(256.0, -(-float(n) // 256.0) * 256.0)
        rows_effective = 0.9 * padded + 0.1 * float(n) + _TILE_OVERHEAD_ROWS
        return rows_effective * self.d * 4.0 / _MODEL_BYTES_PER_NS + k * _PER_K_NS

    def _analytic_grid(self) -> np.ndarray:
        grid = np.zeros((len(self.n_values), len(self.k_values)), dtype=np.float64)
        for i, n in enumerate(self.n_values):
            for j, k in enumerate(self.k_values):
                grid[i, j] = self._analytic_latency(n, k)
        return grid

    def profile_grouped_latency(self, kernel: str | None = None, qt: int = 32,
                                n_queries: int = 1024, device="cpu"):
        """Time the index's grouped scan over the (n, k) grid on `device`
        (quake_tpu/maintenance/latency_estimator.py::profile_grouped_latency;
        the reference profiles its scan_list at build, quake_index.cpp:81-82
        -> maintenance_cost_estimator.cpp:59-94).

        For each n: 32 partitions of exactly n resident rows in a slab of
        256-row padded capacity C, scanned by n_queries queries that each
        probe one random partition; L(n, k) = the amortized call time /
        n_queries, in ns. Each point runs for at least 0.3 s and at least
        n_trials calls, the window bracketed by torch.cuda.synchronize() on
        the card.

        kernel None means "v11" on a CUDA device (kernel K1 with K2) and
        "xla" on the CPU, as the JAX package picks "xla" off a TPU. The K1
        names take the JAX package's groups-per-step at each point's C.
        Deviation: the JAX package drops to "xla" where two slabs pass 12 MiB
        (its kernels' on-chip memory); K1 serves every C up to 65,536, so
        every point here runs the kernel named."""
        from quake_tpu_torch import coordinator

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if kernel is None:
            kernel = "v11" if cuda else "xla"
        Pp = 32
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((n_queries, self.d), generator=gen, device=dev)
        pids = torch.randint(0, Pp, (n_queries, 1), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        for i, n in enumerate(self.n_values):
            C = max(256, -(-int(n) // 256) * 256)
            kern = kernel
            if kernel.startswith(("v11", "v10", "v9", "v8", "v7", "v3p")):
                gpb = max(1, min(4, (12 << 20) // max(2 * C * self.d * 4, 1)))
                base = ("v11" if kernel.startswith("v11")
                        else "v10" if kernel.startswith("v10") else kernel[:2])
                base = base if base in ("v11", "v10", "v9", "v8", "v7") else "v3p"
                kern = f"{base}g{gpb}" if base != "v3p" else f"v3p{gpb}"
            nn = min(int(n), C)
            codes = torch.randn((Pp, C, self.d), generator=gen, device=dev)
            codes[:, nn:] = 0.0
            ids_dev = torch.full((Pp, C), -1, dtype=torch.int32, device=dev)
            ids_dev[:, :nn] = torch.arange(Pp * nn, dtype=torch.int32,
                                           device=dev).reshape(Pp, nn)
            sizes = torch.full((Pp,), nn, dtype=torch.int32, device=dev)
            norms = torch.sum(codes * codes, dim=2)
            # The "xla" scan's map chunk: gc groups of (qt x C scores + a
            # C x d slab) in about 256 MB.
            gc = max(1, min(64, (1 << 28) // max(C * (qt + self.d) * 4, 1)))
            for j, k in enumerate(self.k_values):
                kk = max(min(int(k), C), 1)

                def call():
                    return coordinator.grouped_scan(codes, ids_dev, sizes, norms, q, pids, kk,
                                                    "l2", qt, gc, kern, dense=True)

                call()
                sync()
                t0 = time.perf_counter()
                call()
                sync()
                est = max(time.perf_counter() - t0, 1e-5)
                reps = max(int(0.3 / est), self.n_trials)
                t0 = time.perf_counter()
                for _ in range(reps):
                    call()
                sync()
                per_call = (time.perf_counter() - t0) / reps
                self.latency_grid[i, j] = per_call / n_queries * 1e9
            del codes, ids_dev, norms
        self.grid_source = "profiled"

    # -- estimation ------------------------------------------------------------

    def estimate_scan_latency(self, n: float, k: float) -> float:
        """Bilinear interpolation in the grid; linear extrapolation beyond
        (maintenance_cost_estimator.cpp:126-253)."""
        n = max(float(n), float(self.n_values[0]))
        k = max(float(k), float(self.k_values[0]))
        nv, kv = self.n_values, self.k_values

        def bracket(vals, x):
            if x >= vals[-1]:
                return len(vals) - 2, len(vals) - 1
            lo = 0
            for idx in range(len(vals) - 1):
                if vals[idx] <= x:
                    lo = idx
                else:
                    break
            return lo, lo + 1

        i0, i1 = bracket(nv, n)
        j0, j1 = bracket(kv, k)
        n0, n1 = nv[i0], nv[i1]
        k0, k1 = kv[j0], kv[j1]
        tn = (n - n0) / (n1 - n0)
        tk = (k - k0) / (k1 - k0)
        g = self.latency_grid
        v = (
            g[i0, j0] * (1 - tn) * (1 - tk)
            + g[i1, j0] * tn * (1 - tk)
            + g[i0, j1] * (1 - tn) * tk
            + g[i1, j1] * tn * tk
        )
        return float(v)

    # -- persistence -------------------------------------------------------------

    def save(self, path: str):
        """CSV profile cache (maintenance_cost_estimator.cpp:255-365), in the
        JAX package's bytes: csv.writer's \\r\\n rows, grid values as %.6g."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["d", self.d])
            w.writerow(["n"] + self.n_values)
            w.writerow(["k"] + self.k_values)
            for row in self.latency_grid:
                w.writerow([f"{v:.6g}" for v in row])

    @classmethod
    def from_csv(cls, path: str) -> "ListScanLatencyEstimator | None":
        """An estimator on the grid the CSV itself declares (the load path:
        a saved profile defines its own grid); None where there is none."""
        if not os.path.exists(path):
            return None
        with open(path) as f:
            rows = list(csv.reader(f))
        if len(rows) < 3:
            return None
        est = cls(
            d=int(rows[0][1]),
            n_values=[int(v) for v in rows[1][1:]],
            k_values=[int(v) for v in rows[2][1:]],
            packaged=False,
        )
        est.load(path)
        return est

    def load(self, path: str) -> bool:
        """Load a saved profile; a grid other than this estimator's raises
        ValueError (maintenance_cost_estimator.cpp:255-365, test
        latency_estimator.cpp:116)."""
        if not os.path.exists(path):
            return False
        with open(path) as f:
            rows = list(csv.reader(f))
        if len(rows) < 3:
            return False
        d = int(rows[0][1])
        n_values = [int(v) for v in rows[1][1:]]
        k_values = [int(v) for v in rows[2][1:]]
        if d != self.d or n_values != self.n_values or k_values != self.k_values:
            raise ValueError("latency profile grid mismatch")
        grid = np.array([[float(v) for v in r] for r in rows[3:]], dtype=np.float64)
        if grid.shape != (len(self.n_values), len(self.k_values)):
            raise ValueError("latency profile grid mismatch")
        self.latency_grid = grid
        self.grid_source = "csv"
        return True
