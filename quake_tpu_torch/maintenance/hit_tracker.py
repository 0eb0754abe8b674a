"""Sliding window of per-query partition hits (the counterpart of
quake_tpu/maintenance/hit_tracker.py).

Mirrors the reference HitCountTracker (src/cpp/include/hit_count_tracker.h:
21-114, src/cpp/src/hit_count_tracker.cpp): a circular window (default 1000
queries) of per-query hit partition ids and scanned sizes, with a running
average scan fraction.

The window is one ring on the host: a [window_size, M] array of hit pids (M
the widest hit list recorded so far, the ring widened when a wider one
arrives), a mask of the live hits in each entry, the scanned sizes, a head
index and a fill count. The search path records device tensors as they are
(references, no copy and no host read); a pending batch comes to the host
with one copy when the window is inspected, at maintenance time, and goes
into the ring with array operations. Threads may search one index at once,
so every method that reads or writes the window holds the tracker's lock.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class HitCountTracker:
    def __init__(self, window_size: int, total_vectors: int):
        self.window_size = int(window_size)
        self.total_vectors = max(int(total_vectors), 1)
        self._pending: list[tuple] = []  # (pids [B, M], scanned [B]) as recorded
        self._pending_queries = 0
        # Hits that invalidate_rows cleared, over the tracker's life.
        self.invalidated_hits = 0
        self._lock = threading.RLock()
        self._clear_ring()

    def _clear_ring(self):
        self._hits = np.zeros((self.window_size, 0), np.int64)
        self._live = np.zeros((self.window_size, 0), bool)
        self._sizes = np.zeros(self.window_size, np.int64)
        self._head = 0  # slot of the oldest entry
        self._count = 0  # entries in the ring

    # -- the ring ------------------------------------------------------------

    def _slots(self) -> np.ndarray:
        """The filled slots, oldest first."""
        return (self._head + np.arange(self._count)) % self.window_size

    def _push(self, hits: np.ndarray, live: np.ndarray, sizes: np.ndarray):
        """Append entries (hits [n, m] under the mask live, sizes [n]) after
        the newest, overwriting the oldest once the ring is full."""
        W = self.window_size
        if W <= 0:
            return
        hits, live, sizes = hits[-W:], live[-W:], sizes[-W:]
        n, m = hits.shape
        if m > self._hits.shape[1]:
            wide = np.zeros((W, m), np.int64)
            wide_live = np.zeros((W, m), bool)
            wide[:, :self._hits.shape[1]] = self._hits
            wide_live[:, :self._live.shape[1]] = self._live
            self._hits, self._live = wide, wide_live
        slots = (self._head + self._count + np.arange(n)) % W
        self._hits[slots, :m] = hits
        self._live[slots, :m] = live
        self._live[slots, m:] = False
        self._sizes[slots] = sizes
        total = self._count + n
        if total > W:
            self._head = (self._head + total - W) % W
        self._count = min(total, W)

    def _drop_oldest(self, n: int):
        n = min(n, self._count)
        if n > 0:
            self._head = (self._head + n) % self.window_size
            self._count -= n

    # -- recording -----------------------------------------------------------

    def add_query_data(self, pids: np.ndarray, scanned_size: int):
        """Host-side record of one query's hits (hit_count_tracker.cpp:43-66)."""
        with self._lock:
            hits = np.asarray(pids, dtype=np.int64).reshape(1, -1)
            self._push(hits, np.ones(hits.shape, bool),
                       np.asarray([int(scanned_size)], np.int64))

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
            self._drop_oldest(self._count + self._pending_queries - self.window_size)

    def _materialize(self, partition_sizes: np.ndarray | None = None):
        """Move the pending batches into the ring: one copy to the host per
        batch (pids and scanned side by side). An entry's hits are its first
        `scanned` valid ranks, its scanned size their partitions' sizes
        summed (0 without partition_sizes)."""
        with self._lock:
            for pids_dev, scanned_dev in self._pending:
                both = torch.cat([pids_dev.to(torch.int64),
                                  scanned_dev.to(torch.int64).reshape(-1, 1)], dim=1).cpu().numpy()
                pids, scanned = both[:, :-1], both[:, -1]
                valid = pids >= 0
                rank = np.cumsum(valid, axis=1)
                live = valid & (rank <= scanned[:, None])
                # Compacted: each entry's hits first, in rank order.
                counts = live.sum(axis=1)
                hits = np.zeros((len(pids), int(counts.max(initial=0))), np.int64)
                r, c = np.nonzero(live)
                hits[r, rank[r, c] - 1] = pids[r, c]
                sizes = np.zeros(hits.shape, np.int64)
                kept = np.arange(hits.shape[1]) < counts[:, None]
                if partition_sizes is not None:
                    sizes[kept] = partition_sizes[hits[kept]]
                self._push(hits, kept, sizes.sum(axis=1))
            self._pending.clear()
            self._pending_queries = 0

    # -- inspection ----------------------------------------------------------

    def get_num_queries_recorded(self) -> int:
        with self._lock:
            return self._count + self._pending_queries

    def get_per_query_hits(self, partition_sizes: np.ndarray | None = None):
        """The window as a list of per-query hit pid arrays, oldest first."""
        with self._lock:
            self._materialize(partition_sizes)
            if not self._count:
                return []
            slots = self._slots()
            live = self._live[slots]
            cuts = np.cumsum(live.sum(axis=1))[:-1]
            return np.split(self._hits[slots][live], cuts)

    def hit_counts(self, num_partitions: int,
                   partition_sizes: np.ndarray | None = None) -> np.ndarray:
        """Per-partition hit counts [num_partitions] (int64) over the window,
        hits outside [0, num_partitions) left out; the pending batches are
        materialized first (with partition_sizes, as get_per_query_hits)."""
        with self._lock:
            self._materialize(partition_sizes)
            slots = self._slots()
            hits = self._hits[slots][self._live[slots]]
            hits = hits[(hits >= 0) & (hits < num_partitions)]
            return np.bincount(hits, minlength=num_partitions).astype(np.int64)

    @property
    def _scanned_sizes(self) -> list[int]:
        """The materialized entries' scanned sizes, oldest first (read only)."""
        with self._lock:
            return self._sizes[self._slots()].tolist()

    def get_current_scan_fraction(self) -> float:
        """Running average of (scanned vectors / ntotal) per query
        (hit_count_tracker.cpp:43-66)."""
        with self._lock:
            if not self._count:
                return 1.0
            return float(np.mean(self._sizes[self._slots()]) / self.total_vectors)

    def invalidate_rows(self, rows):
        """Drop hits attributed to rows whose identity was recycled (the
        materialized entries; pending batches are left as recorded)."""
        rows = np.fromiter((int(r) for r in rows), np.int64)
        if not rows.size:
            return
        with self._lock:
            slots = self._slots()
            gone = self._live[slots] & np.isin(self._hits[slots], rows)
            self._live[slots] &= ~gone
            self.invalidated_hits += int(gone.sum())

    def reset(self):
        with self._lock:
            self._clear_ring()
            self._pending.clear()
            self._pending_queries = 0
