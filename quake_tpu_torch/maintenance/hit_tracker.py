"""Sliding window of per-query partition hits (the counterpart of
quake_tpu/maintenance/hit_tracker.py).

Mirrors the reference HitCountTracker (src/cpp/include/hit_count_tracker.h:
21-114, src/cpp/src/hit_count_tracker.cpp): a circular window (default 1000
queries) of per-query hit partition ids and scanned sizes, with a running
average scan fraction.

The search path records device tensors as they are (references, no copy and
no host read); a pending batch comes to the host with one copy when the
window is inspected, at maintenance time. Threads may search one index at
once, so every method that reads or writes the window holds the tracker's
lock.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class HitCountTracker:
    def __init__(self, window_size: int, total_vectors: int):
        self.window_size = int(window_size)
        self.total_vectors = max(int(total_vectors), 1)
        self._queries: list[np.ndarray] = []  # per-query hit pid arrays
        self._scanned_sizes: list[int] = []  # per-query total scanned vectors
        self._pending: list[tuple] = []  # (pids [B, M], scanned [B]) as recorded
        self._pending_queries = 0
        self._lock = threading.RLock()

    # -- recording -----------------------------------------------------------

    def add_query_data(self, pids: np.ndarray, scanned_size: int):
        """Host-side record of one query's hits (hit_count_tracker.cpp:43-66)."""
        with self._lock:
            self._queries.append(np.asarray(pids, dtype=np.int64))
            self._scanned_sizes.append(int(scanned_size))
            self._trim()

    def add_batch_device(self, pids_dev: torch.Tensor, scanned_dev: torch.Tensor):
        """Record a batch of queries without reading the device. pids_dev
        [B, M] int32 ranked candidates (-1 pad); scanned_dev [B] int32, the
        number of leading valid ranks actually scanned. The tensors are kept
        by reference: the caller must not write into them afterwards."""
        with self._lock:
            b = int(pids_dev.shape[0])
            self._pending.append((pids_dev, scanned_dev))
            self._pending_queries += b
            # A circular window (hit_count_tracker.cpp:43-66): an old pending
            # batch is dropped only when the batches retained after it already
            # fill the window (none of its entries could survive the trim), and
            # host entries are trimmed by count, so interleaved host and device
            # recording keeps every entry still in the window.
            while (
                self._pending_queries - int(self._pending[0][0].shape[0])
                >= self.window_size
            ):
                dropped = self._pending.pop(0)
                self._pending_queries -= int(dropped[0].shape[0])
            excess = len(self._queries) + self._pending_queries - self.window_size
            if excess > 0:
                n = min(excess, len(self._queries))
                del self._queries[:n]
                del self._scanned_sizes[:n]

    def _materialize(self, partition_sizes: np.ndarray | None = None):
        """Move the pending batches into the host window: one copy to the
        host per batch (pids and scanned side by side)."""
        with self._lock:
            for pids_dev, scanned_dev in self._pending:
                both = torch.cat([pids_dev.to(torch.int64),
                                  scanned_dev.to(torch.int64).reshape(-1, 1)], dim=1).cpu().numpy()
                pids, scanned = both[:, :-1], both[:, -1]
                for qi in range(pids.shape[0]):
                    n = int(scanned[qi])
                    hits = pids[qi][pids[qi] >= 0][:n]
                    self._queries.append(hits)
                    if partition_sizes is not None and hits.size:
                        sz = int(partition_sizes[hits].sum())
                    else:
                        sz = 0
                    self._scanned_sizes.append(sz)
            self._pending.clear()
            self._pending_queries = 0
            self._trim()

    def _trim(self):
        excess = len(self._queries) - self.window_size
        if excess > 0:
            del self._queries[:excess]
            del self._scanned_sizes[:excess]

    # -- inspection ----------------------------------------------------------

    def get_num_queries_recorded(self) -> int:
        with self._lock:
            return len(self._queries) + self._pending_queries

    def get_per_query_hits(self, partition_sizes: np.ndarray | None = None):
        with self._lock:
            self._materialize(partition_sizes)
            return self._queries

    def get_current_scan_fraction(self) -> float:
        """Running average of (scanned vectors / ntotal) per query
        (hit_count_tracker.cpp:43-66)."""
        with self._lock:
            if not self._scanned_sizes:
                return 1.0
            return float(np.mean(self._scanned_sizes) / self.total_vectors)

    def invalidate_rows(self, rows):
        """Drop hits attributed to rows whose identity was recycled."""
        with self._lock:
            rowset = set(int(r) for r in rows)
            self._queries = [
                q[~np.isin(q, list(rowset))] if q.size else q for q in self._queries
            ]

    def reset(self):
        with self._lock:
            self._queries.clear()
            self._scanned_sizes.clear()
            self._pending.clear()
            self._pending_queries = 0
