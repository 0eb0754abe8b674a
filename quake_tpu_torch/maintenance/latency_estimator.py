"""Partition-scan latency model for maintenance cost estimation (the
counterpart of quake_tpu/maintenance/latency_estimator.py).

Mirrors the reference ListScanLatencyEstimator
(src/cpp/include/maintenance_cost_estimator.h,
src/cpp/src/maintenance_cost_estimator.cpp:126-365): a grid of latencies over
n in {1..65536} x k in {1..256}, bilinear interpolation inside the grid,
linear extrapolation beyond it, CSV save and load in the JAX package's bytes
(either package loads what the other saved).

Three sources for the grid values, each named by `grid_source`:
  * analytic: the JAX package's byte/overhead model with its constants (the
    default off the card, as the JAX package keeps it off its TPU);
  * packaged: grids measured on the H100 and committed with this package
    (data/h100_grouped_latency_d*.csv, written by
    scripts/measure_latency_grid.py), interpolated onto the estimator's
    points and carried to its d (affine in d between the two grids nearest
    it); the default of an estimator for a CUDA device, as the JAX package
    defaults to its measured grid on its TPU;
  * profiled: the index's own grouped scan timed over the grid
    (`profile_grouped_latency`; on a CUDA device kernel K1 with K2, in device
    time, replayed from a CUDA graph), like the reference's empirical grid
    (maintenance_cost_estimator.cpp:59-94), or the flat scan of n rows and
    one query (`profile_scan_latency`, the reference's own profile).
Both profiles run on the estimator's device, else on the CUDA card (they
raise without one); the CPU runs them only when the caller asks for it.
A profiled grid or one loaded from a saved profile ("csv") overrides the
packaged one.
"""

from __future__ import annotations

import csv
import glob
import os
import re
import statistics
import time

import numpy as np
import torch

from quake_tpu_torch.params import (
    DEFAULT_LATENCY_ESTIMATOR_NTRIALS,
    DEFAULT_LATENCY_ESTIMATOR_RANGE_K,
    DEFAULT_LATENCY_ESTIMATOR_RANGE_N,
)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
PACKAGED_GLOB = "h100_grouped_latency_d*.csv"

# A d without a grid of its own. The JAX package scales its one grid by
# L(d) = L(dref) x ((1 - s) + s x d / dref), a fixed cost and a cost per
# dimension with one share s = 0.55 for every point (a TPU v5e figure). On
# the H100 the share is not one number: from d = 128 to d = 768 a point's
# latency grows 1.15-1.66x for n <= 256 (the launch sets the time) and
# 3.3-5.3x for n >= 16384 (K1's scan does). So the port takes the two
# committed grids nearest d and makes each point affine in d between them
# (affine_in_d): the same two components, with the share measured at each
# point. Held against a grid measured at d = 384 and not committed
# (scripts/measure_latency_grid.py --check 384, on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit), this misses by 6.2% RMS and 15.7% at worst;
# the one share fitted over all points of the two grids (s = 0.0822) misses
# by 48.0% RMS and 105.8% at worst.

# The analytic model's constants (the JAX package's values): a partition of
# n rows costs (0.9 x its 256-row padded capacity + 0.1 n + one tile of
# overhead rows) x d x 4 bytes at _MODEL_BYTES_PER_NS, plus _PER_K_NS a
# result. With alpha = 0.9 splitting breaks even near 8 tiles (~2048 rows).
_MODEL_BYTES_PER_NS = 800.0
_TILE_OVERHEAD_ROWS = 256.0
_PER_K_NS = 2.0
_PROFILE_REPS = 10  # graph replays a trial of the device-time profile


def monotone(grid: np.ndarray) -> np.ndarray:
    """The grid made non-decreasing along n (axis 0), then along k (axis 1),
    by running maxima, as the JAX package projects it."""
    return np.maximum.accumulate(np.maximum.accumulate(grid, axis=0), axis=1)


def affine_in_d(g0: np.ndarray, d0: int, g1: np.ndarray, d1: int, d: int) -> np.ndarray:
    """The grid at d from grids measured at d0 and d1, each point affine in
    d through the two (beyond them, extrapolated)."""
    return g0 + (float(d) - d0) / float(d1 - d0) * (g1 - g0)


def device_call_ms(fn, trials: int, device, reps: int = _PROFILE_REPS) -> float:
    """Device milliseconds of one fn() on a CUDA device: fn captured once in
    a CUDA graph (after two calls on a side stream: the kernels' build and
    the allocator's warm-up), then the median over `trials` of CUDA events
    around `reps` replays of the graph, which the host enqueues far faster
    than the card runs them. fn must not wait for the card (a capture
    refuses a synchronizing call)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(max(int(trials), 1)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(statistics.median(times))


def host_call_s(fn, trials: int) -> float:
    """Seconds of one fn() on the host clock, amortized over a window of at
    least 0.3 s and at least `trials` calls (the CPU's profile)."""
    fn()
    t0 = time.perf_counter()
    fn()
    est = max(time.perf_counter() - t0, 1e-5)
    reps = max(int(0.3 / est), int(trials))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


class ListScanLatencyEstimator:
    def __init__(
        self,
        d: int,
        n_values=None,
        k_values=None,
        n_trials: int = DEFAULT_LATENCY_ESTIMATOR_NTRIALS,
        packaged: bool | None = None,
        device=None,
    ):
        self.d = int(d)
        self.device = device  # where the profiles run; None: the CUDA card
        self.n_values = list(n_values or DEFAULT_LATENCY_ESTIMATOR_RANGE_N)
        self.k_values = list(k_values or DEFAULT_LATENCY_ESTIMATOR_RANGE_K)
        self.n_trials = int(n_trials)
        self.latency_grid = self._analytic_grid()
        # Provenance of the grid: "analytic", "packaged(d=N,scale=S)" (the
        # committed H100 grid, d-scaled), "profiled" (timed on this index's
        # device) or "csv" (loaded from a saved profile).
        self.grid_source = "analytic"
        # packaged None: the committed grid where `device` is a CUDA device
        # (the card it was measured on), else the analytic model; True and
        # False force it.
        if packaged is None:
            packaged = self._device_is_cuda(device)
        if packaged:
            self._apply_packaged_profile()

    @staticmethod
    def _device_is_cuda(device) -> bool:
        return device is not None and torch.device(device).type == "cuda"

    @classmethod
    def _packaged_profiles(cls):
        """The committed measured grids, {d: path}."""
        out = {}
        for p in glob.glob(os.path.join(DATA_DIR, PACKAGED_GLOB)):
            m = re.search(r"_d(\d+)\.csv$", p)
            if m:
                out[int(m.group(1))] = p
        return out

    def _packaged_on_points(self, path: str):
        """The committed grid at `path` projected to be non-decreasing in n
        and k (the delta formulas need L monotone, and a measurement's noise
        can leave it locally decreasing) and interpolated onto this
        estimator's (n, k) points; None where the file holds no grid.
        from_csv builds its estimator with packaged=False, so the load does
        not come back here (the JAX package guards it with a flag)."""
        ref = ListScanLatencyEstimator.from_csv(path)
        if ref is None:
            return None
        ref.latency_grid = monotone(ref.latency_grid)
        n = np.asarray(self.n_values, dtype=np.float64)[:, None]
        return ref.estimate_scan_latency_array(n, np.asarray(self.k_values, dtype=np.float64))

    def _apply_packaged_profile(self, share: float | None = None):
        """The default grid from the committed measured ones
        (quake_tpu/maintenance/latency_estimator.py::_apply_packaged_profile),
        projected again after it is carried to this d. With `share` a
        number, the JAX package's law: the grid nearest in d by log ratio,
        scaled by (1 - share) + share x d / dref. With `share` None, this
        card's: at a committed d that grid as it is; at another, each point
        affine in d between the two grids nearest d (affine_in_d; the one
        grid unscaled where only one is committed). An explicit profile or
        a loaded CSV overrides it."""
        profiles = self._packaged_profiles()
        if not profiles:
            return
        near = sorted(profiles, key=lambda dd: abs(np.log(dd / self.d)))
        dref = near[0]
        ref = self._packaged_on_points(profiles[dref])
        if ref is None:
            return
        if share is not None or self.d == dref or len(near) == 1:
            share = 0.0 if share is None else float(share)
            scale = (1.0 - share) + share * self.d / float(dref)
            grid = ref * scale
            source = f"packaged(d={dref},scale={scale:.3f})"
        else:
            other = self._packaged_on_points(profiles[near[1]])
            if other is None:
                return
            grid = affine_in_d(ref, dref, other, near[1], self.d)
            source = f"packaged(d={min(dref, near[1])}..{max(dref, near[1])},at={self.d})"
        self.latency_grid = monotone(grid)
        self.grid_source = source

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

    def _profile_device(self, device) -> torch.device:
        """The device a profile runs on: `device`, else the estimator's own,
        else the CUDA card (index.resolve_device, which raises without one).
        The JAX package picks by its default backend; the port runs on the
        card unless the caller asks for the CPU."""
        from quake_tpu_torch.index import resolve_device

        return resolve_device(device if device is not None else self.device)

    def profile_scan_latency(self, device=None):
        """Time the flat scan over the (n, k) grid
        (quake_tpu/maintenance/latency_estimator.py::profile_scan_latency,
        maintenance_cost_estimator.cpp:59-94): at each point, ops/scan.py::
        flat_scan of one query against n random rows with kk = min(k, n), in
        ns a call. On a CUDA device that is device time (device_call_ms: the
        call captured in a CUDA graph, the median over n_trials trials of
        CUDA events around _PROFILE_REPS replays); host-timed device work
        reads the host's pace, not the card's. On the CPU the host clock
        (host_call_s). The device rule is _profile_device's. The rows and
        the query come from a torch.Generator seeded with 0 on the device,
        where the JAX method draws from numpy's global random state: the
        data differ, the function does not."""
        from quake_tpu_torch.ops.scan import flat_scan

        dev = self._profile_device(device)
        cuda = dev.type == "cuda"
        gen = torch.Generator(device=dev).manual_seed(0)
        for i, n in enumerate(self.n_values):
            codes = torch.randn((int(n), self.d), generator=gen, device=dev)
            ids = torch.arange(int(n), dtype=torch.int32, device=dev)
            q = torch.randn((1, self.d), generator=gen, device=dev)
            for j, k in enumerate(self.k_values):
                kk = min(int(k), int(n))

                def call():
                    return flat_scan(q, codes, ids, kk, "l2")

                if cuda:
                    per_call = device_call_ms(call, self.n_trials, dev) * 1e-3
                else:
                    per_call = host_call_s(call, self.n_trials)
                self.latency_grid[i, j] = per_call * 1e9
            del codes, ids
        self.grid_source = "profiled"

    def profile_grouped_latency(self, kernel: str | None = None, qt: int = 32,
                                n_queries: int = 1024, device=None):
        """Time the index's grouped scan over the (n, k) grid on `device`
        (quake_tpu/maintenance/latency_estimator.py::profile_grouped_latency;
        the reference profiles its scan_list at build, quake_index.cpp:81-82
        -> maintenance_cost_estimator.cpp:59-94).

        The device is `device`, else the estimator's own, else the CUDA card
        (raises without one; _profile_device): the CPU runs only when the
        caller asks for it.

        For each n: 32 partitions of exactly n resident rows in a slab of
        256-row padded capacity C, scanned by n_queries queries that each
        probe one random partition; L(n, k) = the time of one call /
        n_queries, in ns. On a CUDA device that time is device time: the
        call captured in a CUDA graph, the median over n_trials trials of
        CUDA events around _PROFILE_REPS replays (device_call_ms). On the
        CPU each point runs for at least 0.3 s and at least n_trials calls
        on the host clock.

        kernel None means "v11" on a CUDA device (kernel K1 with K2) and
        "xla" on the CPU, as the JAX package picks "xla" off a TPU. The K1
        names take the JAX package's groups-per-step at each point's C.
        Deviation: the JAX package drops to "xla" where two slabs pass 12 MiB
        (its kernels' on-chip memory); K1 serves every C up to 65,536, so
        every point here runs the kernel named."""
        from quake_tpu_torch import coordinator

        dev = self._profile_device(device)
        cuda = dev.type == "cuda"
        if kernel is None:
            kernel = "v11" if cuda else "xla"
        Pp = 32
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((n_queries, self.d), generator=gen, device=dev)
        pids = torch.randint(0, Pp, (n_queries, 1), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

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

                if cuda:
                    per_call = device_call_ms(call, self.n_trials, dev) * 1e-3
                else:
                    per_call = host_call_s(call, self.n_trials)
                self.latency_grid[i, j] = per_call / n_queries * 1e9
            del codes, ids_dev, norms
            if cuda:  # a slab at n = 65,536 and d = 768 takes 6.4 GB
                torch.cuda.empty_cache()
        self.grid_source = "profiled"

    # -- estimation ------------------------------------------------------------

    def estimate_scan_latency(self, n: float, k: float) -> float:
        """Bilinear interpolation in the grid; linear extrapolation beyond
        (maintenance_cost_estimator.cpp:126-253). One point of
        estimate_scan_latency_array."""
        return float(self.estimate_scan_latency_array(float(n), float(k)))

    def estimate_scan_latency_array(self, n, k) -> np.ndarray:
        """estimate_scan_latency at every point of n and k (arrays or
        scalars, broadcast together), in float64. Each value is the JAX
        package's scalar lookup to the bit: the bracket is the last grid value at or below
        the point (np.searchsorted(..., side="right") - 1) after the point
        is raised to the grid's first value, capped at the last interval, so
        that a point at or beyond the grid's end sits in the last interval
        (extrapolation), and the terms are summed in the scalar formula's
        order."""
        nv = np.asarray(self.n_values, dtype=np.int64)
        kv = np.asarray(self.k_values, dtype=np.int64)
        n = np.maximum(np.asarray(n, dtype=np.float64), float(nv[0]))
        k = np.maximum(np.asarray(k, dtype=np.float64), float(kv[0]))
        # At or above the first grid value, so the bracket is at least 0.
        i0 = np.minimum(np.searchsorted(nv, n, side="right") - 1, len(nv) - 2)
        j0 = np.minimum(np.searchsorted(kv, k, side="right") - 1, len(kv) - 2)
        i1, j1 = i0 + 1, j0 + 1
        n0, n1 = nv[i0], nv[i1]
        k0, k1 = kv[j0], kv[j1]
        tn = (n - n0) / (n1 - n0)
        tk = (k - k0) / (k1 - k0)
        g = self.latency_grid
        return (
            g[i0, j0] * (1 - tn) * (1 - tk)
            + g[i1, j0] * tn * (1 - tk)
            + g[i0, j1] * (1 - tn) * tk
            + g[i1, j1] * tn * tk
        )

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
